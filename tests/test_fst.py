"""FST writer (output/fst.py) against a recorded fake ``rmn`` module.

The real ECCC ``rmn``/``georef`` libraries are proprietary and absent (the
reference has the same optional dependency, output_cubesphere_fst.py:56);
the writer's record construction — angle24-encoded IG1-3, packed IG4,
per-field 64-bit real records — is asserted here through a stand-in that
records every call."""

import sys
import types

import numpy as np
import pytest

from wxfactory_tpu.common.angle24 import decode, encode
from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.output.fst import FstWriter, grid_rotation_metadata, make_ig4
from wxfactory_tpu.testcases import williamson_case6


class _FakeFile:
    def __init__(self, path, mode):
        self.path = path
        self.mode = mode
        self.records = []
        self.closed = False

    def write(self, rec, rewrite=0):
        self.records.append(rec)

    def close(self):
        self.closed = True


def _fake_rmn():
    mod = types.ModuleType("rmn")
    mod.files = []

    def fst24_file(path, mode):
        f = _FakeFile(path, mode)
        mod.files.append(f)
        return f

    def fst_record(**kwargs):
        return dict(kwargs)

    mod.fst24_file = fst24_file
    mod.fst_record = fst_record
    mod.FstDataType = types.SimpleNamespace(FST_TYPE_REAL="real")
    return mod


@pytest.fixture
def fake_rmn(monkeypatch):
    mod = _fake_rmn()
    monkeypatch.setitem(sys.modules, "rmn", mod)
    return mod


def test_make_ig4_packs_and_validates():
    assert make_ig4(10, 3) == (10 << 7) | 3
    assert make_ig4(0x1FFFF, 127) == (0x1FFFF << 7) | 127
    with pytest.raises(ValueError):
        make_ig4(0x20000, 3)
    with pytest.raises(ValueError):
        make_ig4(10, 128)


def test_fst_writer_records(fake_rmn, tmp_path):
    nel, s = 4, 2
    lam0, phi0, alp0 = 0.3, -0.4, 0.1
    geom = make_cubed_sphere_2d(nel, s, lam0, phi0, alp0)
    metric = make_metric_2d(geom)
    ops = make_dfr_operators(s)
    q = np.asarray(williamson_case6(geom))

    path = str(tmp_path / "out.fst")
    w = FstWriter(path, geom, metric, ops, "shallow_water", dt=1800.0)
    w.write_sw(7, q)
    w.close()

    f = fake_rmn.files[0]
    assert f.path == path and f.mode == "RSF+R/W"
    assert f.closed
    assert [r["nomvar"] for r in f.records] == ["h", "U", "V"]

    ni = nel * s
    ig1, ig2, ig3, ig4 = grid_rotation_metadata(geom)
    for rec in f.records:
        assert (rec["ni"], rec["nj"], rec["nk"]) == (ni, 6 * ni, 1)
        assert rec["data"].shape == (6 * ni, ni)
        assert rec["data"].dtype == np.float64
        assert (rec["ig1"], rec["ig2"], rec["ig3"], rec["ig4"]) == (ig1, ig2, ig3, ig4)
        assert rec["deet"] == 1800 and rec["npas"] == 7
        assert rec["grtyp"] == "C" and rec["typvar"] == "A"
        assert rec["data_bits"] == 64 and rec["pack_bits"] == 64
    # The rotation survives the 24-bit codec round trip.
    assert abs(decode(ig1) - lam0) < 1e-6
    assert abs(decode(ig2) - phi0) < 1e-6
    assert abs(decode(ig3) - alp0) < 1e-6
    assert ig4 == (nel << 7) | s

    # Record payload is the single-block field itself.
    h_block = geom.to_single_block(q[0]).reshape(6 * ni, ni)
    np.testing.assert_allclose(f.records[0]["data"], h_block)


def test_fst_writer_requires_rmn(tmp_path):
    geom = make_cubed_sphere_2d(2, 2)
    metric = make_metric_2d(geom)
    ops = make_dfr_operators(2)
    sys.modules.pop("rmn", None)
    with pytest.raises(RuntimeError, match="rmn"):
        FstWriter(str(tmp_path / "x.fst"), geom, metric, ops, "shallow_water")


def test_fst_writer_rejects_3d(fake_rmn, tmp_path):
    geom = make_cubed_sphere_2d(2, 2)
    metric = make_metric_2d(geom)
    ops = make_dfr_operators(2)
    with pytest.raises(ValueError, match="2D cubed sphere"):
        FstWriter(str(tmp_path / "x.fst"), geom, metric, ops, "euler")
