"""One intra-op thread a test: the driver runs the suite in several
workers on few cores, and tiny tensors gain nothing from more."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

