"""SDE data generation (counterpart of ``upgdm_tpu/data``): ``sde`` (the four
systems, integrated by K4 on the card), ``graphs`` (the graph families,
without networkx), ``generate`` (the dataset drivers and CLI) and
``bury_sim`` (the Bury-2021 training corpus, numpy on the host)."""
