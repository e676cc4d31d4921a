"""One CPU thread for torch in the port's test modules.

The Tier-1 command runs the suite in six xdist worker processes on one
host. Each torch process starts an intra-op pool as wide as the host's
cores, so six pools (and XLA's own threads) oversubscribe the cores many
times over: a post-tune CLI test that takes ~14 s alone took 444 s in
the suite. A test module that imports :func:`one_torch_thread` runs its
tests, and its module-scoped fixtures, with ``torch.set_num_threads(1)``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one CPU thread for the whole module that imports this
    (set before the module's other module-scoped fixtures, which autouse
    fixtures precede; restored after its last test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
