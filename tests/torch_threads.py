"""Torch's intra-op threads held to two in each test module that imports
``two_torch_threads`` (an autouse fixture): the suite runs several
workers on a few cores beside the JAX package's tests, and torch's
default of one thread per core would have them contend for every core.
JAX-free, so the card's tests (``--noconftest``) can import it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
