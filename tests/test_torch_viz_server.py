"""The port's live viewer (``viz_server.py``) against the JAX package's.

On the two maps of ``tests/test_torch_viz.py`` (the JAX-driven 8-frame
clip saved and loaded by the port, and five keyframes assembled from a
rendered clip with graph edges), the same arrays in both packages:

* the counterpart of ``tests/test_viz.py:36``: the page (byte for byte
  JAX's ``_PAGE``), ``/meta``, ``/cloud`` (its ``<6I`` header, layout,
  unit normals, triangle indices), ``/frame`` and ``/ctrl``; the control
  channel round-trips pause, step and the confidence threshold, which the
  next publish takes;
* ``/cloud``'s blob and ``/meta`` equal those of JAX's ``LiveViewer`` after
  ``publish`` of the same state, bit for bit, at two thresholds; the
  ``/frame`` PNG decodes to the pixels of JAX's;
* the counterpart of ``tests/test_viz.py:125``: a cold publish extracts
  every keyframe, a warm one none, and after ``N_updates`` of the last
  keyframe is bumped in place (``arena_set``) exactly one; the incremental
  blob equals a cache-free rebuild;
* ``publish`` from a second thread, under the system's lock, while the
  frontend tracks the 16-frame oracle clip and the backend thread runs its
  rounds (``single_thread: False``, a shortened switch interval): every
  published row is the row that was written with its ``N_updates``, never a
  mix of two writes.  Every wait has a deadline.
"""

import json
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import viz_server as jviz_server
from mast3r_slam_torch import testing, viz, viz_server
from mast3r_slam_torch.frame import arena_get, arena_set
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config
from _torch_viz_state import map_arenas, viz_systems

DEADLINE_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["clip", "map"])
def state(request, tmp_path_factory):
    """(JAX arena, port arena, ii, jj, stats) of one map."""
    if request.param == "clip":
        jsys, tsys = viz_systems(tmp_path_factory)
        g = tsys.graph
        return (jsys.arena, tsys.arena, g.ii[:g.n_edges], g.jj[:g.n_edges],
                dict(tsys.stats))
    jar, tar, ii, jj = map_arenas()
    return jar, tar, ii, jj, {"keyframes": 5}


@pytest.fixture
def viewers():
    """Viewers made by the test, closed after it."""
    made = []
    yield made
    for v in made:
        v.close()


def _get(viewer, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{viewer.port}{path}", timeout=10).read()


def test_endpoints_and_controls(state, viewers):
    _, tar, ii, jj, stats = state
    viewer = viz_server.LiveViewer(port=0)
    viewers.append(viewer)
    viewer.publish(tar, ii, jj, stats=stats)

    page = _get(viewer, "/")
    assert page == jviz_server._PAGE.encode()
    meta = json.loads(_get(viewer, "/meta"))
    assert meta["version"] == 1 and meta["nkf"] == tar.n_size
    assert meta["npts"] > 0 and meta["nfr"] == 8 * tar.n_size
    assert meta["nedge"] == len(ii) and meta["stats"] == stats

    blob = _get(viewer, "/cloud")
    npts, nfr, nedge, pad1, ntri, pad2 = struct.unpack("<6I", blob[:24])
    assert (npts, nfr, nedge, ntri) == (meta["npts"], meta["nfr"],
                                        meta["nedge"], meta["ntri"])
    assert ntri > 0 and meta["sradius"] > 0
    expect = (24 + npts * 12 + npts * 3 + pad1 + npts * 3 + pad2
              + (nfr + nedge) * 24 + ntri * 12)
    assert len(blob) == expect
    off = 24 + npts * 12 + npts * 3 + pad1
    nrm = np.frombuffer(blob, np.int8, npts * 3, off).reshape(-1, 3)
    ln = np.linalg.norm(nrm.astype(np.float32) / 127.0, axis=-1)
    assert (np.abs(ln - 1.0) < 0.05).mean() > 0.9
    tri = np.frombuffer(blob, np.uint32, ntri * 3, expect - ntri * 12)
    assert tri.max() < npts

    _get(viewer, "/ctrl?pause=1&conf=2.5")
    _get(viewer, "/ctrl?step=1")
    msg = viewer.get_msg()
    assert msg.is_paused and msg.next == 1
    assert abs(msg.C_conf_threshold - 2.5) < 1e-6
    viewer.consume_step()
    assert viewer.get_msg().next == 0
    viewer.publish(tar, stats=stats)
    meta2 = json.loads(_get(viewer, "/meta"))
    assert meta2["version"] == 2 and meta2["conf"] == 2.5
    assert meta2["npts"] <= meta["npts"]

    with pytest.raises(urllib.error.HTTPError):
        _get(viewer, "/frame")          # nothing published yet
    with pytest.raises(urllib.error.HTTPError):
        _get(viewer, "/nothing")
    viewer.publish_frame(tar.uimg[0].numpy())
    png = _get(viewer, "/frame")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(_get(viewer, "/meta"))["frame_version"] == 1
    viewer.publish(tar, stats=stats)
    assert json.loads(_get(viewer, "/meta"))["frame_version"] == 1


@pytest.mark.parametrize("conf", [None, "0.5"])
def test_cloud_and_frame_match_jax(state, viewers, conf):
    jar, tar, ii, jj, stats = state
    viewer = viz_server.LiveViewer(port=0)
    jviewer = jviz_server.LiveViewer(port=0)
    viewers.extend([viewer, jviewer])
    for v in (viewer, jviewer):
        if conf is not None:
            _get(v, f"/ctrl?conf={conf}")
    viewer.publish(tar, ii, jj, stats=stats)
    jviewer.publish(jar, ii, jj, stats=stats)
    assert _get(viewer, "/cloud") == _get(jviewer, "/cloud")
    assert json.loads(_get(viewer, "/meta")) == \
        json.loads(_get(jviewer, "/meta"))

    rng = np.random.default_rng(0)
    for img in (tar.uimg[tar.n_size - 1].numpy(),
                rng.uniform(-0.2, 1.2, (24, 40, 3)).astype(np.float32)):
        viewer.publish_frame(img)
        jviewer.publish_frame(img)
        got, ref = (cv2.imdecode(np.frombuffer(_get(v, "/frame"), np.uint8),
                                 cv2.IMREAD_UNCHANGED)
                    for v in (viewer, jviewer))
        np.testing.assert_array_equal(got, ref)


def test_incremental_publish_dirty_keyframes_only(monkeypatch, viewers):
    _, tar, ii, jj = map_arenas()
    n = tar.n_size
    viewer = viz_server.LiveViewer(port=0)
    viewers.append(viewer)
    calls = []
    orig = viz.extract_kf_grid

    def counting(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(viz, "extract_kf_grid", counting)
    viewer.publish(tar, ii, jj)
    assert len(calls) == n and viewer.rows_pulled == n
    blob1 = viewer._blob

    calls.clear()
    viewer.publish(tar, ii, jj)
    assert len(calls) == 0 and viewer.rows_pulled == n
    assert viewer._blob == blob1

    # fuse into the last keyframe, in place: exactly one dirty row
    kf = arena_get(tar, n - 1)
    arena_set(tar, n - 1, kf.replace(N_updates=kf.N_updates + 1,
                                     X_canon=kf.X_canon * 1.01))
    calls.clear()
    viewer.publish(tar, ii, jj)
    assert len(calls) == 1 and viewer.rows_pulled == n + 1
    assert viewer._blob != blob1
    blob_incr = viewer._blob

    viewer._kf_cache = {}
    viewer._cache_key = None
    viewer.publish(tar, ii, jj)
    assert viewer._blob == blob_incr


def test_publish_during_threaded_rounds(tmp_path, viewers):
    """A second thread publishes under the system's lock while the
    frontend and the backend thread write the arena in place."""
    h, w, n_frames = 48, 64, 16
    jseq = testing.SyntheticSequence(n_frames=n_frames, h=h, w=w, seed=0,
                                     traj_scale=0.5)
    cfg = load_config("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = w
    cfg["single_thread"] = False
    system = SLAMSystem(cfg, testing.OracleEngine(jseq, device="cpu"),
                        (h, w), buffer=32, device="cpu")
    written = {}          # (row, N_updates) -> the row's arrays

    def keep(fn, row_of):
        def hook(frame):
            row = row_of()
            written[(row, int(frame.N_updates))] = tuple(
                np.array(t) for t in (frame.X_canon, frame.C, frame.N,
                                      frame.uimg))
            return fn(frame)
        return hook

    system._arena_append = keep(system._arena_append,
                                lambda: system.arena.n_size)
    system._arena_set_last = keep(system._arena_set_last,
                                  lambda: system.arena.n_size - 1)
    viewer = viz_server.LiveViewer(port=0)
    viewers.append(viewer)
    stop = threading.Event()
    checked, errors = [], []

    def publisher():
        try:
            while not stop.is_set():
                viewer.publish(system.arena, lock=system._lock)
                thr = viewer.get_msg().C_conf_threshold
                for i, (ver, grid) in list(viewer._kf_cache.items()):
                    X, C, N, U = written[(i, ver)]
                    ref = viz.extract_kf_grid(X, C, N, U, h, w, 1, thr)
                    for a, b in zip(grid, ref):
                        np.testing.assert_array_equal(a, b)
                    checked.append((i, ver))
        except Exception as e:  # re-raised by the test
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=publisher, daemon=True)
    try:
        thread.start()
        end = time.monotonic() + DEADLINE_S
        for i in range(n_frames):
            assert time.monotonic() < end, "the drive outlasted its deadline"
            system.process_frame(i, jseq.images[i])
        testing.drain_within(system, DEADLINE_S)
    finally:
        stop.set()
        thread.join(timeout=DEADLINE_S)
        sys.setswitchinterval(switch)
        system.terminate()
    assert not thread.is_alive()
    assert not errors, errors[0]
    assert system.stats["ba_rounds"] >= 2 and system.stats["keyframes"] >= 3
    rows = {i for i, _ in checked}
    assert rows == set(range(system.arena.n_size))
    assert len(set(checked)) > system.arena.n_size   # rows seen re-fused
