"""Torch's intra-op thread count for every test process that runs a port
test. Each `tests/test_torch_*.py` imports this module, so the cap holds in
each pytest-xdist worker from collection on: six workers that each let
torch claim every core oversubscribe the machine several times over, and
the same work then runs several times slower."""
import pytest

torch = pytest.importorskip("torch")

THREADS = 1
torch.set_num_threads(THREADS)
