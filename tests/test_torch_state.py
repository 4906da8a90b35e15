"""SLAM-state save / resume of the port against the JAX package
(``save_state`` / ``load_state``, ``mast3r_slam_tpu/pipeline.py:687-813``).

On the 16-frame 48x64 oracle clip of ``tests/test_pipeline.py:17`` at
``config/eval_no_calib.yaml`` (backend inline), saved after frame 8:

* Saved, resumed in a fresh system and finished, the port equals its
  uninterrupted run: the same stats, ``n_size``, edges and BA iterations,
  and keyframe poses bit for bit (measured: ``load_state``'s
  re-normalisation leaves these poses' bits as they were), which holds the
  checks of JAX's ``test_state_checkpoint_resume``
  (``tests/test_pipeline.py:115``: keyframes equal, poses within 1e-3).  Saved by a threaded system (whose ``save_state`` drains
  the backend first) the file holds the same arrays as the inline one's.
* A JAX-written file and a port-written one at the same frame have the
  same keys, shapes and dtypes; their integer arrays are equal and their
  float arrays within ``POSE_ATOL`` 1e-4 (measured 1.6e-5: f32 summation
  order in the GN and BA solves, as in ``tests/test_torch_drive.py``).
* A JAX-written file resumed in the port continues as JAX's own resume
  does: the same stats, edges and BA iterations, poses within
  ``POSE_ATOL`` (measured 2.4e-5).
* The legacy layouts load: stats without ``stats_keys`` by the five-key
  order (``tests/test_pipeline.py:210``), a float ``uimg``, a file saved
  after ``terminate``.
* On the 24-frame loop clip with the oracle database
  (``tests/test_retrieval.py:440``) a port-written file resumed by both
  packages replays the restored keyframes into an empty database; the
  port's proposals, stats and edges after the resume equal JAX's, poses
  within ``LOOP_POSE_ATOL`` 2e-5 (measured 2.0e-6).
* ``main_torch.py --state-out`` after 4 of the clip's 8 subsampled frames,
  then ``--resume-state --start-frame 4`` in a fresh run, prints the
  uninterrupted run's ATE, and the two written trajectories score the same
  ATE to the last bit (measured).

``-s`` prints the measured figures.
"""

import numpy as np
import pytest
import torch

import main_torch
from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import evaluate, testing
from mast3r_slam_torch.frame import Mode
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

H, W, N_FRAMES, HALF = 48, 64, 16, 8
POSE_ATOL = 1e-4
LOOP_POSE_ATOL = 2e-5
DEADLINE_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(load, single_thread=True, w=W):
    cfg = load("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = w
    cfg["single_thread"] = single_thread
    return cfg


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(JAX sequence, the port's sequence loaded from its .npz, dir)."""
    d = tmp_path_factory.mktemp("clip")
    jseq = jtesting.SyntheticSequence(n_frames=N_FRAMES, h=H, w=W, seed=0,
                                      traj_scale=0.5)
    jseq.save(d / "oracle.npz")
    tseq = testing.SyntheticSequence.load(d / "oracle.npz")
    tseq.images = [np.asarray(im) for im in jseq.images]
    return jseq, tseq, d


def _port(tseq, start=0, single_thread=True, retrieval=False, w=W):
    engine = testing.OracleEngine(tseq, device="cpu")
    engine._encode_counter = start     # frame identity of the first frame
    return SLAMSystem(
        _cfg(load_config, single_thread, w), engine, (tseq.h, tseq.w),
        buffer=32, device="cpu",
        retrieval=testing.make_oracle_retrieval(tseq, engine)
        if retrieval else None)


def _jax(jseq, start=0, retrieval=False, w=W):
    engine = jtesting.OracleEngine(jseq)
    engine._encode_counter = start
    return JaxSLAMSystem(
        _cfg(jconfig.load_config, True, w), engine, (jseq.h, jseq.w),
        buffer=32,
        retrieval=jtesting.make_oracle_retrieval(jseq, engine)
        if retrieval else None)


def _frames(system, images, lo, hi, drain=False):
    for i in range(lo, hi):
        system.process_frame(i, images[i])
        if drain:
            testing.drain_within(system, DEADLINE_S)


def _finish(system):
    if not system.single_thread:
        testing.drain_within(system, DEADLINE_S)
    system.terminate()
    return system


def _edges(g):
    return g.ii[:g.n_edges].tolist(), g.jj[:g.n_edges].tolist()


def _max_pose_err(a, b, n):
    return float(np.abs(np.asarray(a.T_WC[:n]) - np.asarray(b.T_WC[:n]))
                 .max())


@pytest.fixture(scope="module")
def saved(clip, tmp_path_factory):
    """Files saved after frame ``HALF``: the port inline, the port threaded,
    JAX; and the uninterrupted port run."""
    jseq, tseq, _ = clip
    d = tmp_path_factory.mktemp("state")
    full = _port(tseq)
    _frames(full, jseq.images, 0, N_FRAMES)
    _finish(full)
    paths = {"port": d / "port.npz", "threaded": d / "threaded.npz",
             "jax": d / "jax.npz"}
    inline = _port(tseq)
    _frames(inline, jseq.images, 0, HALF)
    inline.save_state(paths["port"])
    threaded = _port(tseq, single_thread=False)
    _frames(threaded, jseq.images, 0, HALF, drain=True)
    threaded.save_state(paths["threaded"])
    _finish(threaded)
    jsys = _jax(jseq)
    _frames(jsys, jseq.images, 0, HALF)
    jsys.save_state(paths["jax"])
    return paths, full


def test_resume_equals_uninterrupted_run(clip, saved):
    jseq, tseq, _ = clip
    paths, full = saved
    resumed = _port(tseq, start=HALF)
    resumed.load_state(paths["port"])
    assert resumed.mode == Mode.TRACKING and resumed.arena.n_size >= 2
    _frames(resumed, jseq.images, HALF, N_FRAMES)
    _finish(resumed)
    assert resumed.stats == full.stats
    assert full.stats["keyframes"] >= 3 and full.stats["ba_rounds"] >= 2
    n = full.arena.n_size
    assert resumed.arena.n_size == n
    assert _edges(resumed.graph) == _edges(full.graph)
    assert resumed.ba_iters_total == full.ba_iters_total
    assert torch.equal(resumed.arena.T_WC[:n], full.arena.T_WC[:n])
    assert torch.equal(resumed.last_T_WC, full.last_T_WC)


def test_threaded_save_holds_the_inline_arrays(saved):
    """``save_state`` drains the backend thread, so a threaded system run
    with a barrier per frame writes the inline system's file."""
    paths, _ = saved
    a, b = np.load(paths["port"]), np.load(paths["threaded"])
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_and_port_files_have_the_same_layout(saved):
    paths, _ = saved
    t, j = np.load(paths["port"]), np.load(paths["jax"])
    assert set(t.files) == set(j.files)
    assert "arena_K" in t.files and "graph_Qi" in t.files
    worst = 0.0
    for k in sorted(j.files):
        assert t[k].shape == j[k].shape, k
        assert t[k].dtype == j[k].dtype, (k, t[k].dtype, j[k].dtype)
        if np.issubdtype(j[k].dtype, np.floating):
            err = float(np.abs(t[k] - j[k]).max()) if t[k].size else 0.0
            worst = max(worst, err)
            assert err <= POSE_ATOL, (k, err)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    print(f"port file against JAX file: float arrays within {worst:.3g}")


def test_jax_file_resumes_in_the_port(clip, saved):
    jseq, tseq, _ = clip
    paths, _ = saved
    jsys = _jax(jseq, start=HALF)
    jsys.load_state(paths["jax"])
    _frames(jsys, jseq.images, HALF, N_FRAMES)
    jsys.terminate()
    port = _port(tseq, start=HALF)
    port.load_state(paths["jax"])
    assert port.arena.pos.dtype == torch.int64
    assert port.arena.uimg.dtype == torch.uint8
    _frames(port, jseq.images, HALF, N_FRAMES)
    _finish(port)
    assert port.stats == jsys.stats
    assert _edges(port.graph) == _edges(jsys.graph)
    assert port.ba_iters_total == jsys.ba_iters_total
    n = port.arena.n_size
    assert n == int(jsys.arena.n_size)
    err = _max_pose_err(port.arena, jsys.arena, n)
    print(f"JAX file resumed, port against JAX: keyframe poses {err:.3g}")
    assert err <= POSE_ATOL


def test_load_state_legacy_stats_layout(clip, saved, tmp_path):
    """A file without ``stats_keys`` carries the five legacy stats in their
    sorted order; they load by that order, not the new one."""
    _, tseq, _ = clip
    paths, _ = saved
    d = dict(np.load(paths["port"]))
    del d["stats_keys"]
    legacy = {"ba_rounds": 11, "keyframes": 22, "reloc": 33,
              "skipped": 44, "tracked": 55}
    d["stats"] = np.asarray([legacy[k] for k in sorted(legacy)], np.int64)
    np.savez_compressed(tmp_path / "legacy.npz", **d)
    system = _port(tseq)
    system.load_state(tmp_path / "legacy.npz")
    for k, v in legacy.items():
        assert system.stats[k] == v, (k, system.stats)
    assert system.stats["retrieval_edges"] == 0


def test_load_state_older_files(clip, saved, tmp_path):
    """A float ``uimg`` in [0, 1] is requantised to uint8, a file saved in
    TERMINATED resumes TRACKING, one without ``K`` or ``cadence`` keeps the
    system's, and a drifted quaternion comes back normalised."""
    _, tseq, _ = clip
    paths, _ = saved
    d = dict(np.load(paths["port"]))
    u8 = d["arena_uimg"]
    d["arena_uimg"] = u8.astype(np.float32) / 255.0
    d["mode"] = np.asarray(Mode.TERMINATED.value)
    d["arena_T_WC"] = d["arena_T_WC"].copy()
    d["arena_T_WC"][0, 3:7] *= 1.01
    del d["arena_K"], d["cadence"]
    np.savez_compressed(tmp_path / "old.npz", **d)
    system = _port(tseq)
    system.load_state(tmp_path / "old.npz")
    assert system.mode == Mode.TRACKING
    assert torch.equal(system.arena.uimg, torch.from_numpy(u8))
    assert not system.arena.K.any() and system.ba_iters_total == 0
    q = system.arena.T_WC[0, 3:7]
    assert abs(float(torch.linalg.norm(q)) - 1.0) < 1e-6


def test_resume_replays_retrieval_index(tmp_path):
    """The 24-frame loop clip with the oracle database, saved by the port
    after frame 12 and resumed by both packages with an empty database:
    the replay indexes every restored keyframe, and the port's proposals
    and edges after the resume equal JAX's."""
    jseq = jtesting.SyntheticSequence(n_frames=24, h=32, w=48, seed=3,
                                      traj_scale=0.35, loop=True)
    jseq.save(tmp_path / "loop.npz")
    tseq = testing.SyntheticSequence.load(tmp_path / "loop.npz")
    half = 12
    first = _port(tseq, retrieval=True, w=48)
    _frames(first, jseq.images, 0, half)
    kf_half = first.stats["keyframes"]
    first.save_state(tmp_path / "half.npz")
    out = {}
    for side, make, seq in (("jax", _jax, jseq), ("port", _port, tseq)):
        system = make(seq, start=half, retrieval=True, w=48)
        system.load_state(tmp_path / "half.npz")
        assert system.retrieval.kf_counter == kf_half >= 2
        _frames(system, jseq.images, half, len(jseq.images))
        system.terminate()
        out[side] = system
    jsys, port = out["jax"], out["port"]
    assert port.stats["retrieval_proposals"] > \
        first.stats["retrieval_proposals"]
    assert port.stats == jsys.stats
    assert _edges(port.graph) == _edges(jsys.graph)
    n = port.arena.n_size
    err = _max_pose_err(port.arena, jsys.arena, n)
    print(f"loop clip resumed with retrieval, port against JAX: keyframe "
          f"poses {err:.3g}, proposals {port.stats['retrieval_proposals']}")
    assert err <= LOOP_POSE_ATOL


def test_main_torch_state_out_then_resume(clip, tmp_path, monkeypatch,
                                          capsys):
    _, tseq, d = clip
    testing.write_clip(tseq, d)
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    common = ["--dataset", str(d), "--config", "config/eval_no_calib.yaml",
              "--oracle", "--cpu", "--no-viz", "--gt", str(d / "gt.txt"),
              "--ate-max-diff", "0.05"]

    def ate(out):
        return float(out.split("ATE RMSE (Sim3-aligned):")[1].split()[0])

    assert main_torch.main(common + ["--save-as", "full"]) == 0
    full = ate(capsys.readouterr().out)
    assert main_torch.main(common + ["--save-as", "a", "--max-frames", "4",
                                     "--state-out", "s.npz"]) == 0
    out = capsys.readouterr().out
    assert "state saved to s.npz" in out and (tmp_path / "s.npz").exists()
    assert main_torch.main(common + ["--save-as", "b", "--resume-state",
                                     "s.npz", "--start-frame", "4"]) == 0
    out = capsys.readouterr().out
    assert "resumed from s.npz" in out and "mode=Mode.TRACKING" in out
    resumed = ate(out)
    name = d.stem
    scored = [evaluate.ate_rmse(d / "gt.txt",
                                tmp_path / "logs" / run / f"{name}.txt",
                                max_diff=0.05) for run in ("full", "b")]
    print(f"main_torch ATE uninterrupted {full} / resumed {resumed} "
          f"(printed); from the trajectories {scored[0]:.8f} / "
          f"{scored[1]:.8f}")
    assert resumed == full and scored[1] == scored[0]
