"""The port's threaded backend (``single_thread: False``, the setting of
``config/base.yaml``) against its inline backend and the JAX package.

* With a ``drain()`` after every frame the backend thread runs the same
  rounds in the same order as the inline backend, so the port's threaded
  system equals its inline one bit for bit: stats, ``n_size``, poses and
  edges.  The clips: the 12-frame 32x32 clip of
  ``tests/test_pipeline_threading.py:25`` at ``config/base.yaml`` (one
  keyframe there, in JAX too), the 16-frame 48x64 oracle clip at
  ``config/eval_no_calib.yaml`` (4 keyframes, 3 BA rounds) and the
  blackout clip of ``tests/test_retrieval.py:268`` with the oracle
  database (a relocalization through the thread's sentinel).  On the first
  both equal JAX's ``single_thread=True`` run within ``POSE_ATOL`` 5e-6
  (measured 5.5e-7 on the last pose, 0 on the keyframe's: the clip makes
  one keyframe and no BA round, in JAX too).
* Free-running on the 48-frame clip of ``:103``: no backend error, at
  least 2 BA rounds, finite poses, and the backend thread runs PyTorch on
  the module's one thread.
* A poisoned task fails fast: one call, ``drain`` raises, the error clears
  (``:114``).
* Snapshots: a reader thread's 600 snapshots, taken while the frontend
  rewrites the last keyframe, each hold one written version, never a mix;
  a snapshot held across an ``arena_grow`` reads its old rows unchanged.
* Relocalization sentinels coalesce to one attempt
  (``tests/test_retrieval.py:268``), and the port's mode and poses then
  equal JAX's within ``RELOC_POSE_ATOL`` 3e-6 (the drive tests'; measured
  3.6e-7).  ``-s`` prints the measured figures.

Every wait has a deadline (``testing.drain_within``, joins with a
timeout), so a stuck backend fails a test instead of hanging the suite.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import testing
from mast3r_slam_torch.frame import Mode, arena_get
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

POSE_ATOL = 5e-6
RELOC_POSE_ATOL = 3e-6
DEADLINE_S = 120.0
CLIPS = {
    # name: (SyntheticSequence kwargs, config, oracle kwargs, retrieval)
    "base_12": (dict(n_frames=12, h=32, w=32, seed=1, traj_scale=0.4),
                "config/base.yaml", {}, False),
    "oracle_16": (dict(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5),
                  "config/eval_no_calib.yaml", {}, False),
    "reloc_14": (dict(n_frames=14, h=32, w=48, seed=0, traj_scale=0.4),
                 "config/eval_no_calib.yaml", dict(blackout_frames={6}),
                 True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(load, path, w, single_thread):
    cfg = load(path)
    cfg["dataset"]["img_size"] = w
    cfg["single_thread"] = single_thread
    return cfg


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """name -> (JAX sequence, the port's sequence loaded from its .npz)."""
    out = {}
    for name, (kw, _, _, _) in CLIPS.items():
        d = tmp_path_factory.mktemp(name)
        jseq = jtesting.SyntheticSequence(**kw)
        jseq.save(d / "o.npz")
        out[name] = (jseq, testing.SyntheticSequence.load(d / "o.npz"))
    return out


def _port(tseq, name, single_thread, buffer=32):
    kw, path, ekw, retrieval = CLIPS[name]
    engine = testing.OracleEngine(tseq, device="cpu", **ekw)
    return SLAMSystem(
        _cfg(load_config, path, tseq.w, single_thread), engine,
        (tseq.h, tseq.w), buffer=buffer, device="cpu",
        retrieval=testing.make_oracle_retrieval(tseq, engine)
        if retrieval else None)


def _terminate(system):
    """``terminate`` after a bounded drain; the thread must have ended."""
    testing.drain_within(system, DEADLINE_S)
    system.terminate()
    if system._backend_thread is not None:
        assert not system._backend_thread.is_alive()


def _drive(system, images, drain_each=False):
    modes = []
    for i, img in enumerate(images):
        modes.append(system.process_frame(i, img)["mode"])
        if drain_each:
            testing.drain_within(system, DEADLINE_S)
    _terminate(system)
    return modes


def _edges(g):
    return g.ii[:g.n_edges].tolist(), g.jj[:g.n_edges].tolist()


@pytest.fixture(scope="module")
def runs(clips):
    """name -> (inline port system, its modes, threaded drained system,
    its modes), run once."""
    cache = {}

    def get(name):
        if name not in cache:
            jseq, tseq = clips[name]
            inline = _port(tseq, name, single_thread=True)
            threaded = _port(tseq, name, single_thread=False)
            assert threaded._backend_thread.is_alive()
            cache[name] = (inline, _drive(inline, jseq.images), threaded,
                           _drive(threaded, jseq.images, drain_each=True))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CLIPS))
def test_threaded_with_drain_equals_inline(runs, name):
    inline, imodes, threaded, tmodes = runs(name)
    assert not threaded.single_thread and inline.single_thread
    assert tmodes == imodes
    assert threaded.stats == inline.stats
    assert threaded.arena.n_size == inline.arena.n_size
    assert _edges(threaded.graph) == _edges(inline.graph)
    assert threaded.ba_iters_total == inline.ba_iters_total
    n = inline.arena.n_size
    assert torch.equal(threaded.arena.T_WC[:n], inline.arena.T_WC[:n])
    assert torch.equal(threaded.arena.X[:n], inline.arena.X[:n])
    assert torch.equal(threaded.last_T_WC, inline.last_T_WC)
    if name == "oracle_16":
        assert inline.stats["ba_rounds"] >= 3
    if name == "reloc_14":
        assert "RELOC" in imodes and inline.mode == Mode.TERMINATED
        assert inline.reloc_attempts >= 1 and inline.stats["reloc"] >= 1


def test_threaded_and_inline_equal_jax(clips, runs):
    """The 12-frame clip at ``config/base.yaml``: the JAX system with
    ``single_thread=True`` against both port systems."""
    jseq, _ = clips["base_12"]
    inline, imodes, threaded, _ = runs("base_12")
    jsys = JaxSLAMSystem(
        _cfg(jconfig.load_config, "config/base.yaml", jseq.w, True),
        jtesting.OracleEngine(jseq), (jseq.h, jseq.w), buffer=32)
    jmodes = [jsys.process_frame(i, img)["mode"]
              for i, img in enumerate(jseq.images)]
    jsys.terminate()
    assert imodes == jmodes
    assert inline.stats == jsys.stats
    n = int(jsys.arena.n_size)
    assert inline.arena.n_size == n
    assert _edges(inline.graph) == _edges(jsys.graph)
    err = float(np.abs(threaded.arena.T_WC[:n].numpy()
                       - np.asarray(jsys.arena.T_WC[:n])).max())
    last = float(np.abs(threaded.last_T_WC.numpy()
                        - np.asarray(jsys.last_T_WC)).max())
    print(f"threaded port against JAX single_thread: keyframe poses "
          f"{err:.3g}, last pose {last:.3g}")
    assert err <= POSE_ATOL and last <= POSE_ATOL


def test_free_running_backend(tmp_path):
    """The 48-frame clip without a barrier: the thread's rounds overlap the
    frontend's frames; the run must end with no backend error, BA rounds,
    finite poses and the thread on the module's one PyTorch thread."""
    seq = testing.SyntheticSequence(n_frames=48, h=32, w=32, seed=2,
                                    traj_scale=0.4)
    cfg = _cfg(load_config, "config/base.yaml", 32, False)
    system = SLAMSystem(cfg, testing.OracleEngine(seq, device="cpu"),
                        (32, 32), buffer=64, device="cpu")
    threads = []
    task = system._process_task

    def spy(idx):
        threads.append((threading.current_thread().name,
                        torch.get_num_threads()))
        return task(idx)

    system._process_task = spy
    _drive(system, seq.images)
    assert system._backend_error is None
    assert system.stats["tracked"] > 0 and system.stats["ba_rounds"] >= 2
    n = system.arena.n_size
    assert bool(torch.isfinite(system.arena.T_WC[:n]).all())
    assert threads and set(threads) == {("slam-backend", 1)}, set(threads)


def test_poisoned_backend_task_fails_fast(clips):
    """After a backend exception the thread drops the queued tasks, so
    ``drain`` returns and re-raises it; the error is then cleared."""
    jseq, tseq = clips["base_12"]
    system = _port(tseq, "base_12", single_thread=False)
    for i in range(2):
        system.process_frame(i, jseq.images[i])
    testing.drain_within(system, DEADLINE_S)
    calls = []

    def boom(idx):
        calls.append(idx)
        raise RuntimeError("poisoned task")

    system._process_task = boom
    for _ in range(3):
        system.tasks.put(0)
    with pytest.raises(RuntimeError, match="poisoned"):
        testing.drain_within(system, DEADLINE_S)
    assert calls == [0]
    assert system._backend_error is None
    _terminate(system)


def _version(kf, v):
    """The keyframe ``kf`` with every fused field set to version ``v``."""
    T = kf.T_WC.clone()
    T[0] = float(v)
    return kf.replace(X_canon=torch.full_like(kf.X_canon, float(v)),
                      C=torch.full_like(kf.C, float(v)), T_WC=T,
                      N=torch.tensor(v, dtype=torch.int32),
                      N_updates=torch.tensor(v, dtype=torch.int32))


def test_snapshot_never_mixes_two_writes(clips):
    """600 snapshots by a reader thread while the frontend rewrites the last
    keyframe with versions 0, 1, 2, ...: in each snapshot the last row's X, C,
    N, N_updates and pose all hold one version.  The interpreter switches
    threads every 10 us meanwhile, so an unlocked write would be seen
    half done."""
    jseq, tseq = clips["oracle_16"]
    system = _port(tseq, "oracle_16", single_thread=False)
    for i in range(3):
        system.process_frame(i, jseq.images[i])
    testing.drain_within(system, DEADLINE_S)
    n = system.arena.n_size
    base = arena_get(system.arena, n - 1)
    seen, errors = [], []
    stop = threading.Event()

    def reader():
        try:
            while len(seen) < 600 and not stop.is_set():
                snap = system._snapshot()
                assert snap.n_size == n
                vals = {float(snap.X[n - 1].min()), float(snap.X[n - 1].max()),
                        float(snap.C[n - 1].min()), float(snap.C[n - 1].max()),
                        float(snap.N[n - 1]), float(snap.N_updates[n - 1]),
                        float(snap.T_WC[n - 1, 0])}
                seen.append(vals)
        except Exception as e:  # reported below
            errors.append(e)

    system._arena_set_last(_version(base, 0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=reader)
    try:
        t.start()
        v = 0
        while t.is_alive() and v < 100_000:
            v += 1
            system._arena_set_last(_version(base, v))
    finally:
        stop.set()
        t.join(DEADLINE_S)
        sys.setswitchinterval(interval)
    assert not t.is_alive() and not errors, errors
    assert len(seen) == 600
    mixed = [s for s in seen if len(s) != 1]
    assert not mixed, mixed[:3]
    assert len({next(iter(s)) for s in seen}) > 1   # the writes overlapped
    _terminate(system)


def test_snapshot_survives_arena_grow(clips):
    """A snapshot taken before the arena grows keeps reading the rows it
    saw, while the grown arena's rows are rewritten."""
    jseq, tseq = clips["oracle_16"]
    system = _port(tseq, "oracle_16", single_thread=False, buffer=2)
    for i in range(3):
        system.process_frame(i, jseq.images[i])
    testing.drain_within(system, DEADLINE_S)
    snap = system._snapshot()
    n = snap.n_size
    before = {k: getattr(snap, k)[:n].clone()
              for k in ("frame_id", "uimg", "T_WC", "X", "C", "N",
                        "N_updates", "feat", "pos")}
    live = system.arena
    while system.arena.buffer == live.buffer:
        system._arena_append(arena_get(system.arena, 0))
    assert system.arena is not live and system.arena.buffer > live.buffer
    for r in range(n):
        system.arena.X[r] += 1.0
        system.arena.feat[r] += 1.0
        system.arena.uimg[r] += 1
    system.arena.T_WC[:n, :3] += 1.0
    for k, t in before.items():
        assert torch.equal(getattr(snap, k)[:n], t), k
    assert torch.equal(snap.K, system.arena.K)
    _terminate(system)


def test_reloc_sentinels_coalesce_to_one_attempt(clips):
    """The threaded frontend posts one sentinel per lost frame: five queued
    sentinels after frame 10 (the first that relocalizes) make one
    attempt, and the port's mode and poses then equal JAX's."""
    jseq, tseq = clips["reloc_14"]
    jeng = jtesting.OracleEngine(jseq, blackout_frames={6})
    jsys = JaxSLAMSystem(
        _cfg(jconfig.load_config, "config/eval_no_calib.yaml", jseq.w, True),
        jeng, (jseq.h, jseq.w), buffer=32,
        retrieval=jtesting.make_oracle_retrieval(jseq, jeng))
    tsys = _port(tseq, "reloc_14", single_thread=True)
    tsys_modes = []
    for i in range(7):
        jsys.process_frame(i, jseq.images[i])
        tsys_modes.append(tsys.process_frame(i, jseq.images[i])["mode"])
    assert jsys.mode.name == tsys.mode.name == "RELOC"
    for i in range(7, 11):
        jf = jsys.create_frame(i, jseq.images[i])
        X, C = jeng.inference_mono(jf.feat[None], jf.pos[None])
        jf = jsys._mono_update(jf, X, C)
        tf = tsys._mono_frame(tsys.create_frame(i, jseq.images[i]))
    jsys._reloc_frame, tsys._reloc_frame = jf, tf
    n0, t0 = jsys.reloc_attempts, tsys.reloc_attempts
    for system in (jsys, tsys):
        for _ in range(5):
            system.tasks.put(-1)
        while not system.tasks.empty():
            system._backend_once()
    assert tsys.mode == Mode.TRACKING and jsys.mode.name == "TRACKING"
    assert tsys.reloc_attempts - t0 == 1 == jsys.reloc_attempts - n0
    assert tsys.stats == jsys.stats
    assert _edges(tsys.graph) == _edges(jsys.graph)
    n = tsys.arena.n_size
    assert n == int(jsys.arena.n_size)
    err = float(np.abs(tsys.arena.T_WC[:n].numpy()
                       - np.asarray(jsys.arena.T_WC[:n])).max())
    last = float(np.abs(tsys.last_T_WC.numpy()
                        - np.asarray(jsys.last_T_WC)).max())
    print(f"reloc coalescing, port against JAX: keyframe poses {err:.3g}, "
          f"last pose {last:.3g}")
    assert err <= RELOC_POSE_ATOL and last <= RELOC_POSE_ATOL
    jsys.terminate()
    _terminate(tsys)
