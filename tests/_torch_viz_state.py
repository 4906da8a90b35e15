"""Keyframe maps in both packages, for the viewer tests: the 8-frame 32x48
oracle clip of ``tests/test_viz.py:13`` driven by the JAX ``SLAMSystem``
(``config/eval_no_calib.yaml``, the backend inline), saved with its
``save_state`` and loaded by each package's ``load_state``; and a map
assembled in numpy (``map_arenas``)."""

import fcntl
import os

from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import testing
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

H, W, N_FRAMES, BUFFER = 32, 48, 8, 16


def viz_systems(tmp_path_factory):
    """(JAX system, port system), each holding the state the JAX system
    saved after the clip.  The JAX drive runs once per test session: the
    file is kept in the session's temporary root, which every xdist worker
    of the session shares, and written under a lock."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "torch_viz_state.npz"
    cfg = jconfig.load_config("config/eval_no_calib.yaml", set_global=False)
    cfg["dataset"]["img_size"] = W
    with open(root / "torch_viz_state.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            seq = jtesting.SyntheticSequence(n_frames=N_FRAMES, h=H, w=W,
                                             seed=0, traj_scale=0.5)
            jsys = JaxSLAMSystem(cfg, jtesting.OracleEngine(seq), (H, W),
                                 buffer=BUFFER)
            for i in range(N_FRAMES):
                jsys.process_frame(i, seq.images[i])
            jsys.terminate()
            tmp = root / f"torch_viz_state.{os.getpid()}.npz"
            jsys.save_state(tmp)
            os.replace(tmp, path)
    jsys = JaxSLAMSystem(cfg, jtesting.OracleEngine(
        jtesting.SyntheticSequence(n_frames=1, h=H, w=W)), (H, W),
        buffer=BUFFER)
    jsys.load_state(path)

    tcfg = load_config("config/eval_no_calib.yaml")
    tcfg["dataset"]["img_size"] = W
    tsys = SLAMSystem(tcfg, testing.OracleEngine(
        testing.SyntheticSequence(n_frames=1, h=H, w=W), device="cpu"),
        (H, W), buffer=BUFFER, device="cpu")
    tsys.load_state(path)
    return jsys, tsys


def map_arenas(seed=0, n_kf=5, buffer=8):
    """A map of ``n_kf`` keyframes assembled in numpy from a rendered
    clip's ground truth (every second frame's camera-frame points and
    pose, its image; confidences drawn so that some pixels fall below the
    viewer's 1.5 threshold, fusion counts 1-3), as the JAX and the port
    ``KeyframeArena`` of the same arrays, with graph edges (ii, jj)."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mast3r_slam_tpu.frame import KeyframeArena as JaxArena
    from mast3r_slam_torch.frame import KeyframeArena

    seq = jtesting.SyntheticSequence(n_frames=2 * n_kf, h=H, w=W,
                                     seed=seed, traj_scale=1.0)
    rng = np.random.default_rng(seed)
    rows = range(0, 2 * n_kf, 2)
    N = np.zeros(buffer, np.int32)
    N[:n_kf] = rng.integers(1, 4, n_kf)
    a = dict(
        frame_id=np.arange(buffer, dtype=np.int32) * 2,
        uimg=np.zeros((buffer, H, W, 3), np.uint8),
        T_WC=np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32),
                     (buffer, 1)),
        X=np.zeros((buffer, H * W, 3), np.float32),
        C=np.zeros((buffer, H * W, 1), np.float32),
        N=N, N_updates=N.copy(),
        feat=np.zeros((buffer, 4, 8), np.float32),
        pos=np.zeros((buffer, 4, 2), np.int32),
        K=np.zeros((3, 3), np.float32))
    for k, i in enumerate(rows):
        a["uimg"][k] = np.round(np.asarray(seq.images[i]) * 255.0)
        a["T_WC"][k] = np.asarray(seq.T_WC[i])
        a["X"][k] = np.asarray(seq.X_cam[i])
        a["C"][k, :, 0] = rng.uniform(0.0, 4.0, H * W) * N[k]
    jarena = JaxArena(**{k: jnp.asarray(v) for k, v in a.items()},
                      n_size=jnp.asarray(n_kf, jnp.int32))
    tarena = KeyframeArena(**{k: torch.from_numpy(v.copy())
                              for k, v in a.items()}, n_size=n_kf)
    ii = np.array([0, 1, 2, 3, 0], np.int32)[:n_kf]
    jj = np.array([1, 2, 3, 4, 3], np.int32)[:n_kf]
    return jarena, tarena, ii, jj
