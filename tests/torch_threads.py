"""One torch thread in each test process of the port's tests.

The suite runs several test processes at once; torch's default of one
thread per core in each of them oversubscribes the host, and the tiny
models' many small ops then wait on each other's threads.  A test module
takes the fixture by importing it (``from torch_threads import
one_torch_thread``); a tool run in a subprocess takes ``ONE_THREAD``.
"""
import pytest
import torch

ONE_THREAD = {'OMP_NUM_THREADS': '1'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
