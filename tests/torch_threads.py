"""The port's CPU tests run torch at two intra-op threads: their SMOKE
shapes gain nothing from more, and the tier-1 run's six workers share the
machine's cores, which torch's default of a thread a core oversubscribes
several times over.  A test module takes the fixture by importing it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
