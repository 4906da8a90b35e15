"""Result export and trajectory evaluation.

Own copy of ``mast3r_slam_tpu/evaluate.py``: TUM-format trajectory from the
keyframe poses, confidence-thresholded PLY reconstruction, keyframe PNG
export, and the built-in ATE-RMSE scorer with Sim(3) Umeyama alignment that
replicates ``evo_ape tum <gt> <traj> -as`` (scripts/eval_tum.sh:46-50).
Everything after the one copy of the arena to the host is numpy.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .frame import KeyframeArena
from .ops import lie_sim3 as sim3
from .ops.geometry import constrain_points_to_ray


def prepare_savedir(save_as: str, dataset) -> tuple[pathlib.Path, str]:
    """``logs/[save_as/]`` and the dataset's name (evaluate.py:23)."""
    save_dir = pathlib.Path("logs")
    if save_as != "default":
        save_dir = save_dir / save_as
    save_dir.mkdir(exist_ok=True, parents=True)
    seq_name = dataset.dataset_path.stem
    return save_dir, seq_name


def save_traj(logdir, logfile, timestamps, arena: KeyframeArena):
    """TUM-format trajectory of keyframe poses, Sim3 -> SE3 by dropping the
    scale (evaluate.py:23-44)."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(exist_ok=True, parents=True)
    n = int(arena.n_size)
    T = arena.T_WC[:n].cpu().numpy()
    q = T[:, 3:7]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)  # as_SE3: drop scale
    ids = arena.frame_id[:n].cpu().numpy()
    with open(logdir / logfile, "w") as f:
        for i in range(n):
            t = timestamps[int(ids[i])]
            x, y, z = T[i, 0:3]
            qx, qy, qz, qw = q[i]
            f.write(f"{t} {x} {y} {z} {qx} {qy} {qz} {qw}\n")


@torch.no_grad()
def save_reconstruction(savedir, filename, arena: KeyframeArena,
                        c_conf_threshold: float, K=None):
    """World-frame point cloud, confidence thresholded (evaluate.py:52).
    With ``K`` (3, 3), the calibrated mode, the pointmaps are first put back
    on their pixel rays."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(exist_ok=True, parents=True)
    n = int(arena.n_size)
    h, w = arena.uimg.shape[1:3]
    X = arena.X[:n]
    if K is not None:
        X = constrain_points_to_ray(
            (h, w), X, torch.as_tensor(K, dtype=X.dtype, device=X.device))
    Xw = sim3.act(arena.T_WC[:n, None, :], X).cpu().numpy()
    colors = arena.uimg[:n].cpu().numpy()  # uint8 RGB
    C = arena.C[:n, :, 0].cpu().numpy()
    N = np.maximum(arena.N[:n].cpu().numpy(), 1)
    conf = C / N[:, None]
    pts, cols = [], []
    for i in range(n):
        valid = conf[i] > c_conf_threshold
        pts.append(Xw[i].reshape(-1, 3)[valid])
        cols.append(colors[i].reshape(-1, 3)[valid])
    save_ply(savedir / filename, np.concatenate(pts), np.concatenate(cols))


def save_keyframes(savedir, timestamps, arena: KeyframeArena):
    """Keyframe PNG dump (evaluate.py:83)."""
    from PIL import Image

    savedir = pathlib.Path(savedir)
    savedir.mkdir(exist_ok=True, parents=True)
    n = int(arena.n_size)
    ids = arena.frame_id[:n].cpu().numpy()
    uimg = arena.uimg[:n].cpu().numpy()  # uint8 RGB
    for i in range(n):
        t = timestamps[int(ids[i])]
        Image.fromarray(uimg[i]).save(savedir / f"{t}.png")


def save_ply(filename, points, colors):
    """Binary little-endian PLY writer (evaluate.py:88-106, without the
    plyfile dependency)."""
    colors = colors.astype(np.uint8)
    pcd = np.empty(
        len(points),
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    pcd["x"], pcd["y"], pcd["z"] = points.T.astype(np.float32)
    pcd["red"], pcd["green"], pcd["blue"] = colors.T
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pcd.tobytes())


def load_ply(filename):
    """Reader for the writer above (tests / tooling)."""
    with open(filename, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int(
            [l for l in header.decode().splitlines()
             if l.startswith("element vertex")][0].split()[-1]
        )
        pcd = np.frombuffer(
            f.read(),
            dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")],
            count=n,
        )
    pts = np.stack([pcd["x"], pcd["y"], pcd["z"]], axis=-1)
    cols = np.stack([pcd["red"], pcd["green"], pcd["blue"]], axis=-1)
    return pts, cols


# ---------------------------------------------------------------------------
# Built-in ATE evaluation (evo_ape tum <gt> <est> -as equivalent)
# ---------------------------------------------------------------------------

def load_tum_trajectory(path):
    """(timestamps (N,), positions (N, 3), quaternions xyzw (N, 4))."""
    data = np.loadtxt(path, dtype=np.float64, comments="#")
    data = np.atleast_2d(data)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(t_a, t_b, max_diff=0.01):
    """Nearest-timestamp association with EXACT evo semantics.

    Mirrors ``evo.core.sync.matching_time_indices`` (the machinery under
    ``evo_ape``, the reference protocol's scorer — scripts/eval_tum.sh:
    46-50): iterate over the SHORTER trajectory's stamps, pair each with
    its single nearest stamp in the longer one when within ``max_diff``
    (default 0.01 s), and do NOT enforce uniqueness — evo doesn't either,
    so on dense/ambiguous stamp sets a longer-side stamp may serve two
    pairs, exactly as evo_ape would score it."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    swap = len(t_a) > len(t_b)
    t_s, t_l = (t_b, t_a) if swap else (t_a, t_b)
    jl = np.asarray([int(np.argmin(np.abs(t_l - ts))) for ts in t_s])
    keep = np.abs(t_l[jl] - t_s) <= max_diff
    i_s = np.arange(len(t_s))[keep]
    i_l = jl[keep]
    return (i_l, i_s) if swap else (i_s, i_l)


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform aligning x -> y (Umeyama 1991),
    the alignment inside ``evo_ape -as``.  x, y: (N, 3)."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / len(x)
    c = float(np.trace(np.diag(d) @ S) / var_x) if with_scale else 1.0
    t = my - c * R @ mx
    return R, t, c


def ate_rmse(gt_file, est_file, max_diff=0.01, with_scale=True):
    """ATE RMSE after Sim(3) (default) or SE(3) alignment; mirrors the
    reference eval protocol's ``evo_ape tum gt est -as``."""
    t_g, p_g, _ = load_tum_trajectory(gt_file)
    t_e, p_e, _ = load_tum_trajectory(est_file)
    ie, ig = associate(t_e, t_g, max_diff)
    if len(ie) < 3:
        raise ValueError(
            f"too few associations ({len(ie)}) between {est_file} and "
            f"{gt_file}"
        )
    x = p_e[ie]
    y = p_g[ig]
    R, t, c = umeyama_alignment(x, y, with_scale)
    aligned = (c * (R @ x.T)).T + t
    err = np.linalg.norm(aligned - y, axis=-1)
    return float(np.sqrt((err ** 2).mean()))
