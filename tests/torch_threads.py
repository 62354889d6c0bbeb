"""One intra-op torch thread for the port's test modules.

``from torch_threads import one_thread  # noqa: F401`` makes the fixture
autouse in the importing module.  Under the suite's parallel workers
torch's default thread pool oversubscribes the cores, and its small ops
then wait on one another: a case of many small ops ran tens of times
slower (the gemma2 flash emulation of ``tests/test_torch_split.py``: 32 s
at 8 threads against 0.17 s at 1, next to a loaded suite).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
