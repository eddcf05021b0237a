"""The benchmark's plain float32 PyTorch reference of each model family
(``nsdiff``, ``tmdm``), named by a configuration's ``reference`` key. It
imports torch and numpy only: nothing of the measured program."""
import importlib


def family(name: str):
    """The reference module of a model family (``reference/<name>.py``)."""
    return importlib.import_module(f"{__name__}.{name}")
