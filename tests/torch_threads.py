"""One intra-op thread for torch in the port's CPU tests.

The tier-1 run spreads the suite over six worker processes on the host's
cores. torch's default, one OpenMP thread a core in every process,
oversubscribes them: the threads spin against each other, and a driver
test that takes 4.5 s alone took 384 s in the suite. A port test module
imports `one_torch_thread`, an autouse module fixture that pins torch to
one intra-op thread for the module's tests and restores the count after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
