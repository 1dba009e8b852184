"""Checks that need a GPU: chip_smoke.py's phases at small shapes. They skip
unless JAX's first device is a GPU (the ``gpu_device`` fixture decides inside
each test). Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke(monkeypatch, tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    return cs


def test_e3_epi2_and_plain_references_on_gpu(gpu_device, chip_smoke):
    cs = chip_smoke
    sim, q = cs.run_sim("gpu:epi2", cs.e3_ini("gpu_epi2", "cuda", (4, 3, 3), 10.0, "epi2"))
    assert list(q.devices()) == [gpu_device]
    cs.phase_reference(sim, q, "cuda", canonical_shape=(4, 2, 2))


def test_e3_ros2_converges_on_gpu(gpu_device, chip_smoke):
    cs = chip_smoke
    _sim, q = cs.run_sim("gpu:ros2", cs.e3_ini("gpu_ros2", "cuda", (4, 3, 3), 10.0, "ros2"))
    rho = np.asarray(q)[0]
    assert 0.3 < rho.min() and rho.max() < 1.5


def test_sw_cli_on_gpu(gpu_device, chip_smoke):
    chip_smoke.phase_cli("cuda", shape=(8, 3), dt=1800.0)
