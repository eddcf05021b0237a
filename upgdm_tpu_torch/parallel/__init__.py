"""Multi-device training and sweeps on ``torch.distributed``.

Counterpart of ``upgdm_tpu/parallel/``. One process per device: NCCL between
cards, gloo on the CPU. ``mesh`` starts the process group and describes a
rank, ``draws`` makes each rank draw what one process would draw for its
rows, ``data_parallel`` holds the data-parallel train step and the sharded
sweeps, and ``dryrun`` the multi-device dry run. Importing this package
imports none of them.
"""
