"""The benchmark's CPU tests import the port from ``src/``, as its runs
do (``portbench/run.py``)."""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run tiny tensors: one thread each keeps test workers
    that share the machine from taking its cores from each other."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
