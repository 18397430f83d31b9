"""The port's test modules share one autouse fixture, imported by each:
``from _torch_threads import one_torch_thread``."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's torch work: under parallel test
    workers the OpenMP threads of several processes spin against each other
    (a small PFIT run took some 70× its time alone), and the population
    kill/resume byte equality needs one reduction order too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
