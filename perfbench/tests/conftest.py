import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    """A run on the CPU with few threads: the suite shares the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The harness's cache in a directory of the test's own."""
    from perfbench import harness
    monkeypatch.setattr(harness, "CACHE", tmp_path)
    return tmp_path
