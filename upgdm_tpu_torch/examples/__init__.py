"""The experiment drivers of ``examples/`` on the port, one module per JAX
driver under the same name, each run as ``python -m
upgdm_tpu_torch.examples.<name>`` with ``--device`` (default: the card;
``cpu`` for the CPU) and an output tree of its own (``demo_*_torch``).
``frame`` reduces the statistics CSVs without pandas. Nothing here does
work at import.
"""
