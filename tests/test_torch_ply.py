"""PyTorch port: the native PLY writer and parser against the JAX package.

For every form of cloud (xyz, xyz + BGR colour, xyz + integer and float
intensity) and the precisions 3 and 6, the port's file must be
byte-identical to the JAX package's ``exportPLY`` (its C++ serializer) and
to the port's own ``numpy.savetxt`` writer; ``importPLY`` must read back
exactly what the JAX package's and ``numpy.loadtxt`` read.
"""

import numpy as np
import pytest

import simplestereo_tpu as jss
from simplestereo_tpu_torch import points

KINDS = ("xyz", "rgb", "int", "float")


def _cloud(kind, seed=0, shape=(13, 17)):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 300, shape + (3,)).astype(np.float32)
    pts[0, 0] = [np.inf, -np.inf, np.nan]  # positive NaN: "nan" both ways
    pts[0, 1] = [0.0, -0.0, 1e-9]
    pts[1, 0] = [123456789.125, -0.0005, 0.0005]
    ref = None
    if kind == "rgb":
        ref = rng.integers(0, 256, shape + (3,), np.uint8)
    elif kind == "int":
        ref = rng.integers(0, 256, shape, np.uint8)
    elif kind == "float":
        ref = rng.random(shape).astype(np.float32)
    return pts, ref


@pytest.mark.parametrize("precision", [3, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_export_bytes(tmp_path, kind, precision):
    pts, ref = _cloud(kind)
    files = {}
    for name, fn in (("port", points.exportPLY),
                     ("plain", points._export_ply_plain),
                     ("jax", jss.points.exportPLY)):
        files[name] = tmp_path / f"{name}.ply"
        fn(pts, str(files[name]), referenceImage=ref, precision=precision)
    port = files["port"].read_bytes()
    assert port == files["jax"].read_bytes()
    assert port == files["plain"].read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_import_matches(tmp_path, kind):
    pts, ref = _cloud(kind, seed=1)
    path = str(tmp_path / "c.ply")
    jss.points.exportPLY(pts, path, referenceImage=ref)
    cols = tuple(range({"xyz": 3, "rgb": 6}.get(kind, 4)))
    port = points.importPLY(path, *cols)
    np.testing.assert_array_equal(port, jss.points.importPLY(path, *cols))
    np.testing.assert_array_equal(port, points._import_ply_plain(path, *cols))
    np.testing.assert_array_equal(points.importPLY(path),
                                  jss.points.importPLY(path))


def test_large_cloud_chunks(tmp_path):
    """More points than several formatting chunks hold (16,384 each, one
    thread a core, written in order): the same bytes as the plain
    writer."""
    pts, ref = _cloud("rgb", seed=2, shape=(300, 200))
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    points._export_ply_plain(pts, str(b), referenceImage=ref)
    points.exportPLY(pts, str(a), referenceImage=ref)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(points.importPLY(str(a), *range(6)),
                                  points._import_ply_plain(str(a),
                                                           *range(6)))


def test_malformed_raises(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                    "property double x\nproperty double y\nend_header\n"
                    "1 2\n3\n5 6\n")
    with pytest.raises(ValueError, match="malformed"):
        points.importPLY(str(path), 0, 1)
    path.write_text("ply\nformat ascii 1.0\nend_header\n1 2 3\n")
    with pytest.raises(ValueError, match="no vertex"):
        points.importPLY(str(path))
    with pytest.raises(OSError):
        points.exportPLY(np.zeros((2, 3)), str(tmp_path / "no" / "x.ply"))
