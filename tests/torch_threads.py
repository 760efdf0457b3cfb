"""A module-scoped autouse fixture for the port's heaviest CPU test files:
one intra-op thread for torch while the module runs.

The tier-1 suite runs six pytest workers on the host's cores; each torch
op that spreads over every core then contends with the other workers
(a module that takes 44 s alone took 650 s in the suite).  One thread a
worker gives the same results to within float rounding and frees the
cores.  Import the fixture into a test module to use it:
``from torch_threads import one_torch_thread  # noqa: F401``.
Not a test file.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
