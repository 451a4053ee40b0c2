"""PyTorch port: the matching and scanning example scripts of the lawn
pair and the FTP rig (008 and 009 at DOWN 2, 011, 103), each held against
the JAX package's script on the same stand-in resource tree
(``tests/torch_example_res.py``, "small": the lawn pair 320x180 at
rectified disparity 11.25 with 4-px texels, the camera-projector rig
320x180) and against the tree's truth.

Tolerances (``torch_example_res``): each matcher's map (kept by a spy on
``compute``) and the PNG made of it differ on at most 1% of pixels
(near-ties); 011's WLS on JAX's map within 2e-3 of its scale
(tests/test_torch_wls.py's gate for zero-confidence fills), and its
reprojection and PLY on JAX's WLS output the same point count and points
within rtol 1e-5; 011's own WLS call given JAX's arguments (the guide the
channel mean of a rectified image within the uint8 rule, the same
lambda, sigma, invalid and scale), its output within 2e-3 of the scale
on all but 1% of pixels (0.0% measured) and its lawn.ply's points within
rtol 1e-3 on all but 1% of them (0.0035% measured), colours by the uint8
rule; 103's cloud within 1e-2 units; at least 90% of the lawn's
interior within 1 px of the plane's disparity (the port's maps); 103's
z within tests/test_active.py's 2% (median) and 5% (80th percentile) of
the plane's 1500.
"""

import numpy as np

import simplestereo_tpu as jss
import simplestereo_tpu_torch as ss
import torch_example_res as res
from simplestereo_tpu_torch.imgio import imread

# 008 and 009 run at half size (their DOWN argument): 009's D = 90 and
# window of 35 at 320x180 would be the costliest run of tier-1.
DOWN = 2


tree = res.tree_fixture("2", "stereoFTP")


def maps_of(monkeypatch, cls_name):
    """Spies on ``compute`` of the matcher class in both packages."""
    return [res.record(monkeypatch, getattr(pkg.passive, cls_name),
                       "compute") for pkg in (jss, ss)]


def test_008_stereo_matching_sgm(tree, tmp_path, monkeypatch):
    root, truth = tree
    jm, pm = maps_of(monkeypatch, "StereoSGM")
    (j, _), (p, _) = res.run_both("008_stereo_matching_sgm.py", root,
                                  tmp_path, [DOWN])
    res.maps_close(np.asarray(jm[0][2]), pm[0][2])
    res.maps_close(imread(str(j / "disparity_sgm.png")),
                   imread(str(p / "disparity_sgm.png")))
    share = res.plane_share(pm[0][2] / 16, truth["2"], DOWN, 7, 96 // DOWN)
    assert share >= res.PLANE_BAR, share


def test_009_stereo_matching_asw(tree, tmp_path, monkeypatch):
    root, truth = tree
    jm, pm = maps_of(monkeypatch, "StereoASW")
    (j, _), (p, _) = res.run_both("009_stereo_matching_asw.py", root,
                                  tmp_path, [DOWN])
    res.maps_close(np.asarray(jm[0][2]), pm[0][2])
    res.maps_close(imread(str(j / "disparity_asw.png")),
                   imread(str(p / "disparity_asw.png")))
    share = res.plane_share(pm[0][2], truth["2"], DOWN, 35, 90 // DOWN)
    assert share >= res.PLANE_BAR, share


def test_011_build_3d_point_cloud(tree, tmp_path, monkeypatch):
    root, truth = tree
    jm, pm = maps_of(monkeypatch, "StereoSGM")
    jr, pr = [res.record(monkeypatch, pkg.RectifiedStereoRig,
                         "rectifyImages") for pkg in (jss, ss)]
    jw, pw = [res.record(monkeypatch, pkg.passive, "wls_filter_disparity")
              for pkg in (jss, ss)]
    (j, _), (p, _) = res.run_both("011_build_3d_point_cloud.py", root,
                                  tmp_path)
    raw16 = np.asarray(jm[0][2])
    res.maps_close(raw16, pm[0][2])
    # The port's script joins matcher, WLS and PLY as JAX's does: its WLS
    # is given its own matcher's map, a guide that is the channel mean of
    # its rectified left image (that image within the uint8 rule of
    # JAX's), and JAX's lambda, sigma, invalid and scale.
    (ja, jk, jout), (pa, pk, pout) = jw[0], pw[0]
    assert np.array_equal(pa[0], pm[0][2])
    pimg1 = pr[0][2][0]
    res.uint8_close(np.asarray(jr[0][2][0]), pimg1, where="rectified left")
    for (a, _, _), img in ((jw[0], jr[0][2][0]), (pw[0], pimg1)):
        np.testing.assert_array_equal(np.asarray(a[1]),
                                      np.asarray(img).mean(-1))
    assert {k: v for k, v in pk.items() if k != "device"} == jk, (jk, pk)
    # Its output and lawn.ply against JAX's: the near-ties of the matcher
    # spread through the WLS, so a share of pixels may differ.
    want, got = np.asarray(jout), np.asarray(pout)
    off = float((np.abs(got - want) > res.WLS_TOL * np.abs(want).max())
                .mean())
    assert off <= res.MAP_SHARE, f"{off:.4%} of the WLS output differs"
    res.ply_share(j / "lawn.ply", p / "lawn.ply")
    # The WLS spreads a near-tie of the matcher over its neighbours, so
    # each later stage is held to JAX's on JAX's own input: the WLS
    # within tests/test_torch_wls.py's gate for zero-confidence fills on
    # a noise guide, the reprojection and PLY writer within PLY_RTOL.
    img1 = np.asarray(jr[0][2][0])
    got = ss.passive.wls_filter_disparity(*map(np.asarray, ja),
                                          **dict(jk, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=res.WLS_TOL * np.abs(want).max())
    rig = ss.RectifiedStereoRig.fromFile(str(root / "2" / "rigRect.json"),
                                         device="cpu")
    ss.points.exportPLY(rig.get3DPoints(want), str(tmp_path / "lawn.ply"),
                        referenceImage=img1)
    res.ply_close(j / "lawn.ply", tmp_path / "lawn.ply")
    share = res.plane_share(pm[0][2] / 16, truth["2"], 1, 7, 96)
    assert share >= res.PLANE_BAR, share


def test_103_stereo_ftp(tree, tmp_path, monkeypatch):
    root, truth = tree
    jc, pc = [res.record(monkeypatch, pkg.active.StereoFTP, "getCloud")
              for pkg in (jss, ss)]
    (j, jo), (p, po) = res.run_both("103_stereo_ftp.py", root, tmp_path)
    assert "synthesizing a plane capture" in jo and \
        "synthesizing a plane capture" in po
    res.cloud_close(np.asarray(jc[0][2]), pc[0][2])
    res.ply_close(j / "scan.ply", p / "scan.ply")
    med, p80 = res.plane_z(pc[0][2], truth["stereoFTP"]["z0"])
    assert med < 0.02 and p80 < 0.05, (med, p80)
