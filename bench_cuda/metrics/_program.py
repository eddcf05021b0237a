"""Shared by the readers of the program's own spans and counters
(``upgdm_tpu_torch.utils.profiling``). Spans record only while a profiler
records, so their totals are the traced window's; counters count every call
of the run. Each gives an empty dict where the program keeps no such
record."""
from upgdm_tpu_torch.utils import profiling


def spans() -> dict:
    """By span name: ``calls``, ``host_s``, ``self_s``, ``stream_s``."""
    read = getattr(profiling.phase_timer(), "spans", None)
    return read() if read else {}


def counters() -> dict:
    read = getattr(profiling, "counters", None)
    return read() if read else {}


def ratio(counts: dict, num: str, den: str):
    """counts[num] / counts[den], or None without both."""
    return counts[num] / counts[den] if counts.get(den) and num in counts else None
