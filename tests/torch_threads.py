"""The PyTorch port's test modules run PyTorch on one CPU thread.

Each ``tests/test_torch_*.py`` module imports ``one_torch_thread``; pytest
registers the imported fixture as the module's own."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one CPU thread for the module, restored after: the tests'
    tensors are small, and the suite's parallel workers share the cores,
    where PyTorch's idle intra-op threads spin (the plain MSM ran some 17
    times slower on 8 threads beside busy cores than on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
