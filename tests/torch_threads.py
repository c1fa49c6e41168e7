"""A module fixture for the port's CPU tests: torch's default of one
intra-op thread per core oversubscribes the CPU when the suite runs in
several worker processes (a CLI test took 98 s in place of 10 next to four
other workers).  Not collected: the test files import it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
