"""The benchmark's CPU tests serve tiny models in-process while other test
files run beside them: one torch thread each, so that parallel workers do
not oversubscribe the cores and slow each other's serving loops."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
