"""Shared fixture of the tests/test_torch_*.py files.

The suite runs in several worker processes at once; torch's CPU ops would
each start a thread per core and the workers would oversubscribe the
machine.  Importing `torch_threads` into a test module caps torch at two
threads for that module and restores the setting afterwards.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
