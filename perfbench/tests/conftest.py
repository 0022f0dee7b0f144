"""The benchmark's CPU tests run torch on two threads."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
