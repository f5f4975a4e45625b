"""One PyTorch intra-op thread for the port's CPU test modules.

The port's CPU tests run the kernels' plain versions on small batches:
hundreds of tiny tensor operations a call, where intra-op threads do no
work worth sharing and contend with the other test workers
(pytest-xdist runs six on the box's cores) and with each other.  Each
port test module that runs plain versions imports `one_torch_thread`,
an autouse module fixture that sets one thread for the module and puts
the old count back after it.  Measured on a shared 8-core box under
`-n 6 --dist loadfile`: six of the heaviest port test files took 122 s
with one thread against 162 s with eight, and a `MediaStream` send and
receive on the CPU tables 25-100 ms against 300-600 ms.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
