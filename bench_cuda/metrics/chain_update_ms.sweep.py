"""Device milliseconds a chunk of the reverse chain's posterior update and
draw between the step kernel's calls: the stream time between the CUDA
events of the program's ``upgdm.chain.update`` spans (T - 1 a chain) in the
traced window, over its ``upgdm.chain`` calls. None without CUDA events."""
from bench_cuda.metrics._program import spans


def read(ctx):
    s = spans()
    update, chain = s.get("upgdm.chain.update"), s.get("upgdm.chain")
    if not update or not chain or update["stream_s"] is None:
        return None
    return update["stream_s"] * 1e3 / chain["calls"]
