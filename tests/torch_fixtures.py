"""Fixtures shared by the port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test: the port's test tensors are small,
    and the suite runs in several processes at once, where more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
