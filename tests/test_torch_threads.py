"""``one_torch_thread``: a module-scoped autouse fixture for the port's test
files, imported by name (``from test_torch_threads import one_torch_thread``).

The suite runs in several worker processes on few cores.  There torch's
default of one intra-op thread per core oversubscribes the host, and its
small CPU operations wait on their thread pool far longer than they
compute (two CLI tests took 10.5 s on one thread and 122 s on eight, on an
eight-core host with six cores busy).  Module scope, so a module's own
fixtures (a trained run) take one thread too."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
