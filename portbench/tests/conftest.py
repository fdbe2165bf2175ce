"""The benchmark's tests. Run from the checkout's root:

    python -m pytest portbench/tests -q

Tests that need the card carry the ``cuda`` marker and skip themselves
where there is none; on the card, with no JAX installed:

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# tiny tensors: one thread a test process, so that parallel workers do
# not oversubscribe the cores
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself where there is "
        "none")
