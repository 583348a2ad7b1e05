"""The benchmark's CPU tests run on one thread each: the test run starts
several workers, and torch's threads on every one of them would
oversubscribe the cores many times over."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
