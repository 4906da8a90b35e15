"""The command-line drive of the port: oracle clips through the SLAM
system, export, ATE, relocalization, the dataset loaders and
``main_torch.main``.

* A 16-frame 48x64 oracle clip (the fixture of ``tests/test_pipeline.py``)
  is rendered and saved by the JAX ``SyntheticSequence``; the port loads the
  same ``.npz``.  The port's ``SLAMSystem`` and the JAX package's, each
  with its ``OracleEngine`` and its backend inline (``single_thread`` of
  the eval configs), must make the same keyframe decisions, give the same
  stats (4 keyframes, 3 BA rounds), the same edges and the same BA
  iteration total; poses agree to atol 2e-4 (measured 2.2e-5 at most: both
  oracles hand over identical matches and pointmaps, so what differs is
  f32 summation order in the GN solves, chained over 16 frames), ATE
  within 1e-4 of the JAX package's (measured 7.6e-6 and 6e-8; ``-s``
  prints both) and under the JAX tests' limits (0.05 m uncalibrated, 0.1
  m calibrated, ``tests/test_pipeline.py:49, 68``).
* Relocalization on the blackout clip of ``tests/test_retrieval.py:119``
  with one deterministic retrieval stub on both sides: the same mode
  sequence, stats and edges; with ``NullRetrieval`` both stay in RELOC.
* ``evaluate``: the hand-computed Sim(3) case of
  ``tests/test_pipeline.py:259`` to rtol 1e-6, and exact round trips.
* ``dataloader``: equal, array for array, to the JAX loader on the same
  folders.
"""

import copy

import numpy as np
import pytest
import torch

import main_torch
from mast3r_slam_tpu import dataloader as jdl
from mast3r_slam_tpu import evaluate as jevaluate
from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import dataloader as tdl
from mast3r_slam_torch import evaluate, testing
from mast3r_slam_torch.pipeline import NullRetrieval, SLAMSystem
from mast3r_slam_torch.utils.config import load_config
from mast3r_slam_torch.utils.profiler import TRACER

H, W, N_FRAMES = 48, 64, 16
POSE_ATOL = 2e-4
RELOC_POSE_ATOL = 3e-6
ATE_LIMIT = {False: 0.05, True: 0.1}
ATE_ATOL = 1e-4
# the tracer's spans of an oracle run (the oracle engine is no
# InferenceEngine, so no inference.* span); the eval configs run the
# backend inline, a relocalization-free clip
PROFILE_SPANS = ("pipeline.frame", "pipeline.prepare", "tracker.step",
                 "tracker.gn", "frame.fuse", "sync.kf_decision",
                 "pipeline.backend_round", "global_opt.add_factors",
                 "global_opt.solve")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after: the
    suite runs in several worker processes at once, and PyTorch's thread
    pool in each of them then oversubscribes the cores, which slows the
    port's many small ops by more than an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(JAX sequence, the port's sequence loaded from its .npz, clip dir)."""
    d = tmp_path_factory.mktemp("clip")
    jseq = jtesting.SyntheticSequence(n_frames=N_FRAMES, h=H, w=W, seed=0,
                                      traj_scale=0.5)
    jseq.save(d / "oracle.npz")
    tseq = testing.SyntheticSequence.load(d / "oracle.npz")
    tseq.images = [np.asarray(im) for im in jseq.images]
    testing.write_clip(tseq, d)
    return jseq, tseq, d


def _cfg(calib):
    cfg = load_config("config/eval_calib.yaml" if calib
                      else "config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = W
    return cfg


def _run_jax(seq, cfg, calib):
    system = JaxSLAMSystem(cfg, jtesting.OracleEngine(seq), (H, W),
                           K=seq.K if calib else None, buffer=32)
    log = []
    for i in range(len(seq.X_cam)):
        info = system.process_frame(i, seq.images[i])
        log.append((bool(info["new_kf"]), np.asarray(system.last_T_WC)))
    system.terminate()
    return log, system


def _run_port(seq, cfg, calib):
    engine = testing.OracleEngine(seq, device="cpu")
    system = SLAMSystem(cfg, engine, (H, W), K=seq.K if calib else None,
                        buffer=32, device="cpu")
    log = []
    for i in range(len(seq)):
        info = system.process_frame(i, seq.images[i])
        log.append((info["new_kf"], system.last_T_WC.numpy().copy()))
    system.terminate()
    return log, system


@pytest.fixture(scope="module")
def drives(clip):
    """Both packages' systems over the clip, per calibration mode, run
    once for the tests that read them."""
    jseq, tseq, _ = clip
    cache = {}

    def get(calib):
        if calib not in cache:
            cfg = _cfg(calib)
            cache[calib] = (_run_jax(jseq, cfg, calib),
                            _run_port(tseq, cfg, calib))
        return cache[calib]

    return get


@pytest.mark.parametrize("calib", [False, True],
                         ids=["uncalibrated", "calibrated"])
def test_oracle_drive_matches_jax_frontend(clip, drives, calib, tmp_path):
    jseq, tseq, _ = clip
    (jlog, jsys), (tlog, system) = drives(calib)
    assert [k for k, _ in tlog] == [k for k, _ in jlog]
    assert system.stats["skipped"] == 0 and system.stats["keyframes"] >= 2
    assert system.mode.name == "TERMINATED"
    for (_, tT), (_, jT) in zip(tlog, jlog):
        np.testing.assert_allclose(tT, jT, atol=POSE_ATOL, rtol=0)
    n = system.arena.n_size
    np.testing.assert_allclose(system.arena.T_WC[:n].numpy(),
                               np.asarray(jsys.arena.T_WC[:n]),
                               atol=POSE_ATOL, rtol=0)

    evaluate.save_traj(tmp_path, "est.txt", tseq.timestamps, system.arena)
    tseq.write_gt(tmp_path / "gt.txt")
    ate = evaluate.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt",
                            max_diff=0.05)
    assert ate < ATE_LIMIT[calib], ate

    # trajectory round trip: what was written is what the arena holds
    ts, pos, quat = evaluate.load_tum_trajectory(tmp_path / "est.txt")
    ids = system.arena.frame_id[:n].numpy()
    np.testing.assert_allclose(ts, np.asarray(tseq.timestamps)[ids])
    np.testing.assert_allclose(pos, system.arena.T_WC[:n, :3].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=-1), 1.0, rtol=1e-6)

    evaluate.save_reconstruction(tmp_path, "map.ply", system.arena, 0.5,
                                 K=system.K)
    pts, cols = evaluate.load_ply(tmp_path / "map.ply")
    assert len(pts) > 1000 and np.isfinite(pts).all()
    assert cols.dtype == np.uint8 and cols.shape == pts.shape


@pytest.mark.parametrize("calib", [False, True],
                         ids=["uncalibrated", "calibrated"])
def test_oracle_system_backend_matches_jax(clip, drives, calib, tmp_path):
    """The whole system with its backend: JAX's stats (4 keyframes, 3 BA
    rounds), edges and BA iteration total; ATE within 1e-4 of JAX's."""
    jseq, tseq, _ = clip
    (_, jsys), (_, system) = drives(calib)
    assert system.stats == jsys.stats
    assert system.stats["keyframes"] == 4 and system.stats["ba_rounds"] == 3
    g, jg = system.graph, jsys.graph
    assert g.n_edges == jg.n_edges == 3
    np.testing.assert_array_equal(g.ii[:g.n_edges], jg.ii[:jg.n_edges])
    np.testing.assert_array_equal(g.jj[:g.n_edges], jg.jj[:jg.n_edges])
    assert system.ba_iters_total == jsys.ba_iters_total
    assert system.ba_ok_total == jsys.ba_ok_total == 3
    tseq.write_gt(tmp_path / "gt.txt")
    evaluate.save_traj(tmp_path, "port.txt", tseq.timestamps, system.arena)
    jevaluate.save_traj(tmp_path, "jax.txt", jseq.timestamps, jsys.arena)
    ate = evaluate.ate_rmse(tmp_path / "gt.txt", tmp_path / "port.txt",
                            max_diff=0.05)
    jate = jevaluate.ate_rmse(tmp_path / "gt.txt", tmp_path / "jax.txt",
                              max_diff=0.05)
    print(f"oracle ATE {'calibrated' if calib else 'uncalibrated'}: port "
          f"{ate:.6f} m, JAX {jate:.6f} m")
    assert abs(ate - jate) <= ATE_ATOL, (ate, jate)


def test_arena_grows_past_its_buffer(clip):
    """``SLAMSystem`` grows a full arena by a power of two before an append
    would pass its end (pipeline.py:245), the keyframes kept."""
    _, tseq, _ = clip
    system = SLAMSystem(_cfg(False), testing.OracleEngine(tseq, device="cpu"),
                        (H, W), buffer=1, device="cpu")
    frames = [system.create_frame(i, tseq.images[i]) for i in range(3)]
    for k, frame in enumerate(frames):
        system._arena_append(frame.replace(X_canon=frame.X_canon + k))
    assert system.arena.buffer == 4 and system.arena.n_size == 3
    for k in range(3):
        assert int(system.arena.frame_id[k]) == k
        assert torch.equal(system.arena.X[k], frames[k].X_canon + k)
        assert torch.equal(system.arena.feat[k], frames[k].feat)
    assert torch.equal(system.arena.T_WC[3], torch.tensor(
        [0, 0, 0, 0, 0, 0, 1, 1.0]))


class RecentKeyframes:
    """A deterministic retrieval stub: proposes the k most recent
    keyframes, for either package's arena."""

    def update(self, frame, arena, add_after_query, k, min_thresh):
        n = int(arena.n_size)
        return list(range(n - 1, max(n - 1 - k, -1), -1))


@pytest.mark.parametrize("retrieval", [RecentKeyframes, NullRetrieval],
                         ids=["recent-keyframes", "null"])
def test_relocalization_matches_jax(tmp_path, retrieval):
    """The blackout clip of ``tests/test_retrieval.py:119`` (14 frames,
    32x48, frame 6 blacked out): tracking is lost at frame 6; with the
    stub both systems relocalize on the same frame against the same
    keyframe and go on tracking, with the same mode sequence, stats, edges
    and poses within atol 3e-6 (measured 3.6e-7).  With ``NullRetrieval``
    both stay in RELOC."""
    jseq = jtesting.SyntheticSequence(n_frames=14, h=32, w=48, seed=0,
                                      traj_scale=0.4)
    jseq.save(tmp_path / "o.npz")
    tseq = testing.SyntheticSequence.load(tmp_path / "o.npz")
    cfg = load_config("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = 48
    js = JaxSLAMSystem(cfg, jtesting.OracleEngine(jseq, blackout_frames={6}),
                       (32, 48), buffer=32, retrieval=retrieval())
    ts = SLAMSystem(cfg, testing.OracleEngine(tseq, blackout_frames={6},
                                              device="cpu"),
                    (32, 48), buffer=32, retrieval=retrieval(), device="cpu")
    # with no proposals RELOC persists: two frames of it show that
    n_frames = 14 if retrieval is RecentKeyframes else 9
    jmodes, tmodes = [], []
    for i in range(n_frames):
        jmodes.append(js.process_frame(i, jseq.images[i])["mode"])
        tmodes.append(ts.process_frame(i, jseq.images[i])["mode"])
    assert tmodes == jmodes
    assert tmodes[6] == "TRACKING->RELOC"
    assert ts.stats == js.stats and ts.mode.name == js.mode.name
    assert ts.stats["skipped"] == 1 and ts.stats["reloc"] >= 1
    g, jg = ts.graph, js.graph
    np.testing.assert_array_equal(g.ii[:g.n_edges], jg.ii[:jg.n_edges])
    np.testing.assert_array_equal(g.jj[:g.n_edges], jg.jj[:jg.n_edges])
    assert ts.reloc_attempts == js.reloc_attempts
    if retrieval is NullRetrieval:
        assert ts.mode.name == "RELOC" and tmodes[-1] == "RELOC"
        assert ts.stats["keyframes"] == 1 and g.n_edges == 0
        return
    assert ts.mode.name == "TRACKING" and tmodes[-1] == "TRACKING"
    assert ts.stats["tracked"] >= 8 and ts.stats["keyframes"] >= 2
    assert g.n_edges >= 1
    n = ts.arena.n_size
    assert n == int(js.arena.n_size)
    np.testing.assert_allclose(ts.arena.T_WC[:n].numpy(),
                               np.asarray(js.arena.T_WC[:n]),
                               atol=RELOC_POSE_ATOL, rtol=0)


def test_system_refuses_K_that_disagrees_with_the_config(clip):
    _, tseq, _ = clip
    engine = testing.OracleEngine(tseq, device="cpu")
    with pytest.raises(ValueError, match="use_calib"):
        SLAMSystem(_cfg(False), engine, (H, W), K=tseq.K, device="cpu")
    with pytest.raises(ValueError, match="use_calib"):
        SLAMSystem(_cfg(True), engine, (H, W), device="cpu")


def test_port_renders_the_jax_sequence():
    """The port's own renderer and trajectory (numpy + torch) against the
    JAX ones: poses to 1e-6, pointmaps to 1e-4 of a ~4 m scene, images to
    1e-5."""
    kw = dict(n_frames=3, h=24, w=32, seed=1, traj_scale=0.5)
    jseq = jtesting.SyntheticSequence(**kw)
    tseq = testing.SyntheticSequence(**kw)
    np.testing.assert_allclose(tseq.T_WC.numpy(), np.asarray(jseq.T_WC),
                               atol=1e-6)
    np.testing.assert_array_equal(tseq.K, jseq.K)
    assert tseq.timestamps == jseq.timestamps
    for i in range(3):
        np.testing.assert_allclose(tseq.X_cam[i], jseq.X_cam[i], atol=1e-4)
        np.testing.assert_allclose(tseq.X_world[i], jseq.X_world[i],
                                   atol=1e-4)
        np.testing.assert_allclose(tseq.images[i], jseq.images[i], atol=1e-5)
    Xw = tseq.X_world[0]
    for geometric in (False, True):
        np.testing.assert_allclose(
            testing.world_descriptors(Xw, geometric=geometric),
            jtesting.world_descriptors(Xw, geometric=geometric), atol=1e-6)


def test_oracle_engine_outputs_match_jax(clip):
    jseq, tseq, _ = clip
    jeng = jtesting.OracleEngine(jseq)
    teng = testing.OracleEngine(tseq, device="cpu")
    jf = [jeng.encode(None) for _ in range(4)]
    tf = [teng.encode(None) for _ in range(4)]
    np.testing.assert_array_equal(tf[3][0].numpy(), np.asarray(jf[3][0]))
    jout = jeng.match_asymmetric(jf[3][0], jf[3][1], jf[0][0], jf[0][1])
    tout = teng.match_asymmetric(tf[3][0], tf[3][1], tf[0][0], tf[0][1])
    assert len(tout) == len(jout) == 8
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    jX, jC = jeng.inference_mono(jf[2][0], jf[2][1])
    tX, tC = teng.inference_mono(tf[2][0], tf[2][1])
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))


def test_ate_rmse_hand_computed_sim3_case(tmp_path):
    """``tests/test_pipeline.py:259``: gt the 6 axis unit vectors, est with
    a mean-zero perturbation orthogonal to gt, so Umeyama gives R = I,
    t = 0, c = 1 / (1 + 2 e^2 / 3) in closed form."""
    e = 1e-3
    gt = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                   [0, -1, 0], [0, 0, 1], [0, 0, -1]], float)
    d = np.zeros_like(gt)
    d[:2, 2], d[2:4, 2] = e, -e
    est = gt + d
    for name, p in (("gt.txt", gt), ("est.txt", est)):
        with open(tmp_path / name, "w") as f:
            for i in range(len(p)):
                f.write(f"{i * 0.1} {p[i, 0]} {p[i, 1]} {p[i, 2]} 0 0 0 1\n")
    c = 1.0 / (1.0 + 2.0 * e * e / 3.0)
    expected = float(np.sqrt(
        (np.linalg.norm(c * est - gt, axis=-1) ** 2).mean()))
    ate = evaluate.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt")
    assert np.isclose(ate, expected, rtol=1e-6), (ate, expected)
    R, t, c_hat = evaluate.umeyama_alignment(est, gt)
    np.testing.assert_allclose(R, np.eye(3), atol=1e-9)
    assert np.isclose(c_hat, c, rtol=1e-9)
    ia, ib = evaluate.associate(np.array([0.021]), np.array([0.0, 0.02, 0.5]),
                                max_diff=0.05)
    assert list(zip(ia, ib)) == [(0, 1)]


def test_ply_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    evaluate.save_ply(tmp_path / "a.ply", pts, cols)
    p2, c2 = evaluate.load_ply(tmp_path / "a.ply")
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, cols)


def _write_tum_folder(d, frames):
    import cv2

    (d / "rgb").mkdir(parents=True)
    with open(d / "rgb.txt", "w") as f:
        for i, img in enumerate(frames):
            cv2.imwrite(str(d / "rgb" / f"{i}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            f.write(f"{1000.5 + i * 0.033} rgb/{i}.png\n")


@pytest.mark.parametrize("layout,use_calib", [
    ("png_folder", False), ("png_folder", True), ("tum_freiburg1", False),
    ("tum_freiburg1", True)])
def test_load_dataset_matches_jax_loader(tmp_path, layout, use_calib):
    """A folder of PNGs (with its calibration sidecar) and a TUM-layout
    folder: the same class, timestamps, images, shapes and intrinsics as the
    JAX loader, which reads its process-global config where the port takes
    the dict."""
    rng = np.random.default_rng(3)
    if layout == "png_folder":
        seq = testing.SyntheticSequence(n_frames=3, h=H, w=W, seed=2)
        d = tmp_path / "clip"
        testing.write_clip(seq, d)
    else:
        d = tmp_path / "tum" / "rgbd_dataset_freiburg1_x"
        _write_tum_folder(d, [rng.integers(0, 256, (480, 640, 3))
                              .astype(np.uint8) for _ in range(2)])
    cfg = load_config("config/base.yaml")
    cfg["use_calib"] = use_calib
    saved = dict(jconfig.config)
    try:
        jconfig.set_global_config(cfg)
        jds = jdl.load_dataset(str(d))
        jds.subsample(1)
        jshape = jds.get_img_shape()
        jitems = [jds[i] for i in range(len(jds))]
    finally:
        jconfig.set_global_config(saved)
    tds = tdl.load_dataset(str(d), cfg)
    tds.subsample(1)
    assert type(tds).__name__ == type(jds).__name__
    assert len(tds) == len(jds) and tds.get_img_shape() == jshape
    assert tds.has_calib() == jds.has_calib() == use_calib
    for i, (jts, jimg) in enumerate(jitems):
        tts, timg = tds[i]
        assert tts == jts
        np.testing.assert_array_equal(timg, jimg)
    if use_calib:
        for name in ("K", "K_frame", "K_orig", "mapx", "mapy"):
            np.testing.assert_array_equal(
                getattr(tds.camera_intrinsics, name),
                getattr(jds.camera_intrinsics, name), err_msg=name)


def test_imread_without_cv2_gives_the_same_pixels(clip, monkeypatch):
    """Where ``cv2`` is not installed the loader reads through PIL."""
    _, _, d = clip
    with_cv2 = tdl._imread_rgb(d / "000003.png")

    def no_cv2():
        raise ImportError("cv2")

    monkeypatch.setattr(tdl, "_cv2", no_cv2)
    np.testing.assert_array_equal(tdl._imread_rgb(d / "000003.png"), with_cv2)


@pytest.mark.parametrize("config,calib", [
    ("config/eval_no_calib.yaml", False), ("config/eval_calib.yaml", True)])
def test_main_torch_oracle_end_to_end(clip, tmp_path, monkeypatch, capsys,
                                      config, calib):
    """``main_torch.py --dataset <clip> --oracle --cpu --no-viz --gt``:
    writes the trajectory, the .ply, the keyframes and the diagnostics, and
    prints the system's BA rounds and mean BA iterations and the ATE of the
    trajectory its system holds (to the printed 1e-4).  The eval configs
    take every second frame, and on those 8 frames the JAX package's own
    ``SLAMSystem`` with its backend gives 0.0577 m uncalibrated, above the
    16-frame clip's 0.05 m: so the run is held to the JAX system on the
    same 8 frames, as ``main.py`` feeds them, instead of to that limit:
    the same stats, edges and BA iteration total, and an ATE within
    ``ATE_ATOL`` of JAX's (measured 0.057747 against 0.057739 m
    uncalibrated, 0.039821 m on both sides calibrated; ``-s`` prints
    them)."""
    jseq, tseq, d = clip
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    systems = []
    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(main_torch, "run", spy)
    rc = main_torch.main([
        "--dataset", str(d), "--config", config, "--oracle", "--cpu",
        "--no-viz", "--gt", str(d / "gt.txt"), "--ate-max-diff", "0.05",
        "--save-as", "run", "--diag-out", "logs/run/diag.jsonl",
        "--profile"])
    out = capsys.readouterr().out
    assert rc == 0
    name = d.stem
    ate = float(out.split("ATE RMSE (Sim3-aligned):")[1].split()[0])
    (system,) = systems
    sub = int(system.cfg["dataset"]["subsample"])
    evaluate.save_traj(tmp_path, "held.txt", tseq.timestamps[::sub],
                       system.arena)
    held = evaluate.ate_rmse(d / "gt.txt", tmp_path / "held.txt",
                             max_diff=0.05)
    assert abs(ate - held) <= 5e-5   # the printed ATE is rounded to 1e-4
    # the JAX system on the frames main.py takes (main.py:204-233)
    jsub = copy.copy(jseq)
    jsub.X_cam, jsub.X_world = jseq.X_cam[::sub], jseq.X_world[::sub]
    jsub.T_WC, jsub.images = jseq.T_WC[::sub], jseq.images[::sub]
    _, jsys = _run_jax(jsub, _cfg(calib), calib)
    assert system.stats == jsys.stats
    g, jg = system.graph, jsys.graph
    assert g.n_edges == jg.n_edges
    np.testing.assert_array_equal(g.ii[:g.n_edges], jg.ii[:jg.n_edges])
    np.testing.assert_array_equal(g.jj[:g.n_edges], jg.jj[:jg.n_edges])
    assert system.ba_iters_total == jsys.ba_iters_total
    jevaluate.save_traj(tmp_path, "jax.txt", jseq.timestamps[::sub],
                        jsys.arena)
    jate = jevaluate.ate_rmse(d / "gt.txt", tmp_path / "jax.txt",
                              max_diff=0.05)
    print(f"main_torch ATE on {config}: port {held:.6f} m, JAX {jate:.6f} m")
    assert abs(held - jate) <= ATE_ATOL, (held, jate)
    logs = tmp_path / "logs" / "run"
    ts, pos, _ = evaluate.load_tum_trajectory(logs / f"{name}.txt")
    assert len(ts) >= 2 and np.isfinite(pos).all()
    pts, _ = evaluate.load_ply(logs / f"{name}.ply")
    assert len(pts) > 1000
    assert len(list((logs / "keyframes" / name).glob("*.png"))) == len(ts)
    # the eval configs subsample the clip by 2
    diag = (logs / "diag.jsonl").read_text().splitlines()
    assert len(diag) == N_FRAMES // sub
    assert "stats:" in out
    rounds = system.stats["ba_rounds"]
    assert rounds >= 1
    assert f"ba_rounds {rounds} " in out
    assert f"mean_ba_iters {system.ba_iters_total / rounds:.2f}" in out
    # --profile: the tracer's summary, from its records of the run, one
    # row per span (count, mean ms, total s), and off again after the run
    rows = {ln.split()[0]: ln.split()[1:] for ln in out.splitlines()
            if ln.split() and ln.split()[0] in PROFILE_SPANS}
    assert set(rows) == set(PROFILE_SPANS), rows
    assert int(rows["pipeline.frame"][0]) == N_FRAMES // sub
    assert int(rows["tracker.step"][0]) == system.stats["tracked"]
    assert int(rows["global_opt.solve"][0]) >= rounds
    assert "frames (pipeline.frame)" in out
    assert not TRACER.enabled
    assert "the backend runs inline" not in out   # single_thread: True


def test_main_torch_says_the_backend_runs_inline(clip, tmp_path,
                                                 monkeypatch, capsys):
    """``config/base.yaml`` says ``single_thread: False``: ``main_torch.py``
    runs the backend on a thread, as ``main.py`` does, prints no note that
    it runs inline, and the thread's BA rounds reach the printed stats."""
    _, _, d = clip
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    systems = []
    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        assert system._backend_thread.is_alive()
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(main_torch, "run", spy)
    rc = main_torch.main(["--dataset", str(d), "--config", "config/base.yaml",
                          "--oracle", "--cpu", "--no-viz", "--max-frames",
                          "6", "--save-as", "run"])
    out = capsys.readouterr().out
    assert rc == 0
    (system,) = systems
    assert not system.single_thread
    assert not system._backend_thread.is_alive()    # terminate ended it
    assert "runs inline" not in out
    assert system.stats["ba_rounds"] > 0
    assert "ba_rounds " in out and "ba_rounds 0 " not in out


@pytest.mark.parametrize("no_viz", [False, True],
                         ids=["--viz-port", "--no-viz"])
def test_main_torch_runs_the_viewer(clip, tmp_path, monkeypatch, capsys,
                                    no_viz):
    """``--viz-port`` and a run without ``--no-viz`` (the refusals they
    replace named the viewer as a later slice) on ``--cpu``: the live
    viewer serves on the given port (0: a free one), prints ``main.py``'s
    line, receives the map and is closed when the run ends; ``--no-viz``
    starts none."""
    from mast3r_slam_torch import viz_server

    _, _, d = clip
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    viewers = []

    class Kept(viz_server.LiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            viewers.append(self)

    monkeypatch.setattr(viz_server, "LiveViewer", Kept)
    rc = main_torch.main(["--dataset", str(d), "--config",
                          "config/eval_no_calib.yaml", "--oracle", "--cpu",
                          "--viz-port", "0", "--max-frames", "6",
                          "--save-as", "run"] + (["--no-viz"] if no_viz
                                                 else []))
    out = capsys.readouterr().out
    assert rc == 0 and "done: 6 frames" in out
    if no_viz:
        assert not viewers and "live viewer" not in out
        return
    (viewer,) = viewers
    assert viewer.port != 0
    assert f"live viewer: http://127.0.0.1:{viewer.port}/" in out
    assert viewer._meta["version"] >= 2 and viewer._meta["nkf"] >= 1
    assert viewer._frame_png[:8] == b"\x89PNG\r\n\x1a\n"
    assert not viewer._thread.is_alive()


@pytest.mark.parametrize("case", ["tp", "tp-unavailable", "backend-device"])
def test_main_torch_multi_gpu_flags(clip, tmp_path, monkeypatch, capsys,
                                    case):
    """``--tp`` and ``--backend-device`` run on ``--cpu`` (they replace the
    refusal cases of ``test_main_torch_refuses_later_slices``), with the
    device enumerator patched to two CPU entries: ``--tp 2`` builds the
    tensor-parallel engine over a (1, 2) mesh; ``--tp 4`` prints
    ``main.py``'s line and runs unsharded; ``--backend-device 0`` runs the
    backend on a mirror of the arena."""
    from mast3r_slam_torch import device as tdevice

    _, _, d = clip
    monkeypatch.setattr(tdevice, "local_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 2)
    argv = {"tp": ["--tiny-model", "--tp", "2"],
            "tp-unavailable": ["--tiny-model", "--tp", "4"],
            "backend-device": ["--oracle", "--backend-device", "0"]}[case]
    rc, system = _cli_net(d, tmp_path, monkeypatch, argv)
    out = capsys.readouterr().out
    assert rc == 0 and "done: 3 frames" in out
    if case == "tp":
        assert system.engine.mesh.shape == {"edge": 1, "model": 2}
        assert len(system.engine.model.enc_blocks[0].attn.tp.parts) == 2
    elif case == "tp-unavailable":
        assert "--tp 4 needs 4 devices, have 2; running unsharded" in out
        assert system.engine.mesh is None
    else:
        assert system._bdev == torch.device("cpu")
        assert system.mirror_rows_copied >= 1
        assert system._marena.X is not system.arena.X
        assert system.graph.idx_ii2jj.device == system._bdev


def _cli_net(d, tmp_path, monkeypatch, argv, entry=main_torch.main):
    """``entry(argv)`` over the first 3 frames of the clip ``d`` from
    ``tmp_path`` with ``config/base.yaml`` (384x512 frames, the backend on
    a thread); returns (exit code, the system it ran)."""
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    systems = []
    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(main_torch, "run", spy)
    rc = entry(["--dataset", str(d), "--config", "config/base.yaml",
                "--cpu", "--no-viz", "--max-frames", "3", "--save-as", "run",
                *argv])
    return rc, systems[0]


@pytest.mark.parametrize("argv,entry,local", [
    (["--tiny-model", "--int8-encoder"], "main_torch", False),
    (["--tiny-model", "--int8-encoder", "--int8-local-head"], "main_torch",
     True),
    (["--tiny-model"], "main_quantized_torch", False),
    (["--tiny-model", "--int8-local-head"], "main_quantized_torch", True)],
    ids=["int8-encoder", "int8-encoder+local-head", "main_quantized_torch",
         "main_quantized_torch+local-head"])
def test_main_torch_int8_runs(clip, tmp_path, monkeypatch, capsys, argv,
                              entry, local):
    """``--int8-encoder`` (and ``--int8-local-head``) run the clip to exit 0
    through the int8 engine, and ``main_quantized_torch.py`` is
    ``main_torch.py`` with ``--int8-encoder`` added.  Replaces the refusal
    cases of these flags in ``test_main_torch_refuses_later_slices``."""
    import main_quantized_torch

    _, _, d = clip
    fn = main_torch.main if entry == "main_torch" else \
        main_quantized_torch.main
    rc, system = _cli_net(d, tmp_path, monkeypatch, argv, fn)
    out = capsys.readouterr().out
    assert rc == 0
    eng = system.engine
    assert eng.qparams is not None and len(eng.qparams) == 2
    assert (eng.qlocal is not None) is local
    assert eng.qparams["enc_block_0"]["fc1"].w_int8.dtype == torch.int8
    # the random tiny network need not track: the run goes on (RELOC)
    assert "done: 3 frames" in out and "stats:" in out
    assert not system._backend_thread.is_alive()


def test_main_torch_int8_flags_have_no_effect_with_oracle(clip, tmp_path,
                                                          monkeypatch):
    """With ``--oracle`` there is no network: the int8 flags change nothing
    (main.py builds its oracle engine the same way)."""
    _, _, d = clip
    rc, system = _cli_net(d, tmp_path, monkeypatch,
                          ["--oracle", "--int8-encoder", "--int8-local-head"])
    assert rc == 0
    assert type(system.engine).__name__ == "OracleEngine"


@pytest.mark.parametrize("argv", [["--tiny-model"], ["--oracle"]])
def test_main_torch_profile_blocks_skips_without_a_full_net(
        clip, tmp_path, monkeypatch, capsys, argv):
    _, _, d = clip
    rc, _ = _cli_net(d, tmp_path, monkeypatch, ["--profile-blocks", *argv])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[profile-blocks] skipped (oracle/tiny run has no full net)" in out
    assert "NETWORK TIMING BREAKDOWN" not in out


def test_main_torch_profile_blocks_prints_the_breakdown(clip, tmp_path,
                                                        monkeypatch, capsys):
    """A run of the full network (its loader given the tiny model, so no
    checkpoint is read) with ``--profile-blocks`` times the engine's model
    at the run's frame size after the drive and prints the summary."""
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    _, _, d = clip
    seen = []

    def tiny_model(args):
        torch.manual_seed(0)
        return MASt3R(MASt3RConfig.tiny())

    from mast3r_slam_torch.utils import breakdown

    def spy(model, hw, n_chain=8):
        seen.append((model, hw))
        return breakdown_fn(model, hw, n_chain=1)

    breakdown_fn = breakdown.network_breakdown
    monkeypatch.setattr(main_torch, "load_model", tiny_model)
    monkeypatch.setattr(breakdown, "network_breakdown", spy)
    rc, system = _cli_net(d, tmp_path, monkeypatch, ["--profile-blocks"])
    out = capsys.readouterr().out
    assert rc == 0
    assert seen == [(system.engine.model, (384, 512))]
    assert "NETWORK TIMING BREAKDOWN (per tracked frame)" in out
    assert "[profile-blocks] skipped" not in out


def test_main_torch_needs_a_card_without_cpu_flag(clip, tmp_path,
                                                  monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    _, _, d = clip
    monkeypatch.chdir(main_torch.pathlib.Path(main_torch.__file__).parent)
    with pytest.raises(RuntimeError, match="CUDA"):
        main_torch.main(["--dataset", str(d), "--oracle", "--no-viz",
                         "--config", "config/eval_no_calib.yaml"])
