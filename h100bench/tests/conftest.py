"""The benchmark's tests run their tiny problems on one thread a process,
so that parallel test workers do not oversubscribe the cores."""

import pytest
import torch


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
