"""The port's map exports (``viz.py``) against the JAX package's.

Two maps, the same arrays in both packages (``tests/_torch_viz_state.py``):
the 8-frame 32x48 oracle clip of ``tests/test_viz.py:13`` driven by the
JAX ``SLAMSystem``, saved, and loaded by the port's ``load_state`` and by
JAX's (one keyframe; the drive runs once per test session), and five
keyframes assembled from a rendered clip's ground truth with confidences
on both sides of the viewer's threshold.

* ``np_sim3_Rst``, ``extract_kf_grid``, ``grid_stride``,
  ``compose_world_grids`` and the frusta are JAX's code on the same
  arrays: bit for bit.  So is ``_world_cloud_grid``.
* ``_world_cloud``: the same points in the same order, also through the
  seeded subsample, bit for bit (measured: the port's one batched Sim(3)
  action gives JAX's per-keyframe bits on the CPU).
* ``render_snapshot``: JAX writes its PNG with ``cv2``, the port with
  ``zlib``; decoded, at least 99.98% of the 960x960 pixels agree
  (measured 99.9977% and 99.9993%: the frusta's lines are rasterised in
  numpy, a pixel off ``cv2.line`` where the exact line passes midway
  between two; the points are the same).
* ``export_html_viewer``: the file equals JAX's outside the base64 blob,
  and the decoded blobs are equal.
"""

import base64
import re

import cv2
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import viz as jviz
from mast3r_slam_torch import viz
from _torch_viz_state import map_arenas, viz_systems

SNAPSHOT_AGREE = 0.9998


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["clip", "map"])
def arenas(request, tmp_path_factory):
    """(JAX arena, port arena) of one map."""
    if request.param == "clip":
        jsys, tsys = viz_systems(tmp_path_factory)
        return jsys.arena, tsys.arena
    return map_arenas()[:2]


def _rows(arena):
    n = int(arena.n_size)
    return {k: np.asarray(getattr(arena, k))[:n]
            for k in ("T_WC", "X", "C", "N", "uimg")}


def test_arenas_hold_the_same_arrays(arenas):
    jar, tar = arenas
    assert int(jar.n_size) == tar.n_size >= 1
    for k, v in _rows(jar).items():
        np.testing.assert_array_equal(getattr(tar, k)[:tar.n_size].numpy(),
                                      v)


def test_copied_host_functions_are_bitwise(arenas):
    jar, tar = arenas
    r = _rows(jar)
    h, w = tar.img_hw
    rng = np.random.default_rng(0)
    for T in list(r["T_WC"]) + list(rng.standard_normal((4, 8))):
        for a, b in zip(viz.np_sim3_Rst(T), jviz.np_sim3_Rst(T)):
            np.testing.assert_array_equal(a, b)
    for args in [(1, 1, 1, 400_000), (7, 384, 512, 400_000),
                 (20, 384, 512, 300_000), (3, 32, 48, 100)]:
        assert viz.grid_stride(*args) == jviz.grid_stride(*args)
    for stride in (1, 2, 3):
        for thr in (0.5, 1.5):
            grids = []
            for i in range(len(r["X"])):
                g = viz.extract_kf_grid(r["X"][i], r["C"][i], r["N"][i],
                                        r["uimg"][i], h, w, stride, thr)
                ref = jviz.extract_kf_grid(r["X"][i], r["C"][i], r["N"][i],
                                           r["uimg"][i], h, w, stride, thr)
                for a, b in zip(g, ref):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                grids.append(g)
            for a, b in zip(viz.compose_world_grids(grids, r["T_WC"]),
                            jviz.compose_world_grids(grids, r["T_WC"])):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(viz._frusta(tar), jviz._frusta(jar))
    for a, b in zip(viz._world_cloud_grid(tar), jviz._world_cloud_grid(jar)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("conf,max_points", [(1.5, 400_000), (0.5, 400_000),
                                             (0.5, 700)])
def test_world_cloud_matches_jax(arenas, conf, max_points):
    jar, tar = arenas
    pts, cols = viz._world_cloud(tar, conf, max_points)
    jpts, jcols = jviz._world_cloud(jar, conf, max_points)
    assert pts.shape == jpts.shape and len(pts) > 0
    assert pts.dtype == jpts.dtype and cols.dtype == jcols.dtype
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(pts, jpts)
    if max_points < 1000:
        assert len(pts) == max_points


def test_snapshot_matches_jax(arenas, tmp_path):
    jar, tar = arenas
    viz.render_snapshot(tar, tmp_path / "port.png", conf_threshold=0.5)
    jviz.render_snapshot(jar, tmp_path / "jax.png", conf_threshold=0.5)
    got = cv2.imread(str(tmp_path / "port.png"))
    ref = cv2.imread(str(tmp_path / "jax.png"))
    assert got is not None and got.shape == ref.shape == (960, 960, 3)
    assert got.std() > 1.0
    agree = float((got == ref).all(-1).mean())
    print(f"snapshot pixels equal to JAX's: {agree:.6f}")
    assert agree >= SNAPSHOT_AGREE
    # the PNG decodes to the very array it was written from
    img = viz.snapshot_image(tar, 0.5)
    np.testing.assert_array_equal(got[..., ::-1], img)


def test_png_bytes_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (7, 11, 3), np.uint8)
    got = cv2.imdecode(np.frombuffer(viz.png_bytes(img), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., ::-1], img)


def test_html_matches_jax(arenas, tmp_path):
    jar, tar = arenas
    viz.export_html_viewer(tar, tmp_path / "port.html", conf_threshold=0.5)
    jviz.export_html_viewer(jar, tmp_path / "jax.html", conf_threshold=0.5)
    got = (tmp_path / "port.html").read_text()
    ref = (tmp_path / "jax.html").read_text()
    blob = re.compile(r'const DATA = "([^"]*)";')
    assert blob.sub("", got) == blob.sub("", ref)
    assert "webgl" in got and "drawArrays" in got
    data, jdata = (base64.b64decode(blob.search(t).group(1))
                   for t in (got, ref))
    assert len(data) > 0 and data == jdata
