"""The PyTorch port's test modules run PyTorch on one CPU thread, with the
port's default device set to the CPU.

Each ``tests/test_torch_*.py`` module imports ``one_torch_thread``; pytest
registers the imported fixture as the module's own."""

import pytest
import torch

from zerocaf_tpu_torch import config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one CPU thread for the module, restored after: the tests'
    tensors are small, and the suite's parallel workers share the cores,
    where PyTorch's idle intra-op threads spin (the plain MSM ran some 17
    times slower on 8 threads beside busy cores than on one).  The port's
    constructors default to the first CUDA card; the module asks for the
    CPU instead, where the kernels' plain versions run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with config.use_device("cpu"):
        yield
    torch.set_num_threads(threads)
