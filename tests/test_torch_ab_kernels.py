"""``tools/ab_torch_kernels.py`` on the CPU: its parser, and that it
refuses to run without a card before it imports the port."""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import ab_torch_kernels as ab  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize('argv,want', [
    ([], (REPO, '', 20)),
    (['--root', '/tmp/parent', '--label', 'parent', '--reps', '3'],
     ('/tmp/parent', 'parent', 3)),
])
def test_parser(argv, want):
    opts = ab.parse(argv)
    assert (opts.root, opts.label, opts.reps) == want


def test_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    path = list(sys.path)
    with pytest.raises(SystemExit, match='needs a CUDA GPU'):
        ab.main(['--root', '/nonexistent', '--label', 'x'])
    # it left before putting the tree on the path
    assert sys.path == path
