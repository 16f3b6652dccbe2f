"""Tests of the benchmark, on the CPU at small sizes.  Run from the
repository's root: ``python -m pytest -q portbench/tests``.  Cases marked
``cuda`` need a CUDA device and skip without one; on a card machine,
``python -m pytest -q portbench/tests -m cuda`` runs them."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


# the cells at sizes a CPU test holds: (cell, configuration overrides)
SMALL = {
    "rtow.frame": {"res_x": 32, "res_y": 24},
    "dragon.turntable": {"res_x": 32, "res_y": 32, "n_triangles": 2000,
                         "params": {"check_pixels": 256}},
    "rtow.invert": {"res_x": 32, "res_y": 24},
    "rtow.view": {"res_x": 32, "res_y": 24},
}


@pytest.fixture
def small_run():
    """Run a cell on the CPU at its small size for ``seconds``; returns the
    Outcome."""
    from portbench import harness, run

    def go(cell, seed=2**31 + 7, seconds=0.5, trace=0):
        ctx = harness.Context(cell, seed, seconds, trace, device="cpu",
                              overrides=SMALL[cell])
        return run.run_cell(ctx)
    return go
