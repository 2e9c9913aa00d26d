"""One torch intra-op thread while a port test file runs.

The port's CPU tests run tiny models whose ops are microseconds long.
Under the suite's parallel workers torch's default thread pool
oversubscribes the cores: on an 8-core host a 20-step tiny run took
0.4 s alone and 30-120 s beside five busy workers. A test file imports
the fixture below; being autouse and module-scoped, it then holds for
every test of that file:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
