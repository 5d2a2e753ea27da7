"""PyTorch on one intra-op thread while a port test module runs.

The test run gives each of several workers its own process; with PyTorch's
default of one thread per core in every worker, the tiny tensors of these
tests spend their time in the threads' barriers (a cli train test: 1.5 s
alone, 100 s beside six busy workers).  Import the fixture into a test
module to apply it there; the thread count is restored after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
