"""A fixture for the port's replay-heavy CPU tests: one torch intra-op
thread per test module. The tier runs several pytest workers on the
host's cores, and torch's default of one thread per core in each worker
oversubscribes them: the replay tests ran about eight times slower side
by side than with one thread each. Import it into a test module:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
