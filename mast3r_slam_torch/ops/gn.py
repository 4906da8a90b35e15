"""The ray+distance GN tracker solve: the CUDA kernels and their plain
versions.

Counterpart of ``mast3r_slam_tpu/ops/gn_pallas.py`` and of the device
``while_loop`` around it (tracker.py:343-374).  One pass over the matched
points at pose T gives the 27 sums of the closed form under the joint ray
Huber weight (tracker.py:203-298), folded into H (7, 7), g (7,) and the
cost: ``gn_sums`` replaces the Pallas ``_gn_kernel`` (gn_pallas.py:40) with
``csrc/gn.cu``.  ``gn_solve`` runs the whole solve (every iteration's sums,
7x7 solve, retraction and convergence test) in one launch of the same
source's cooperative kernel and reads its result back once; its plain
version ``gn_solve_plain`` is the host loop ``gn_loop`` over the plain sums.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from . import lie_sim3 as sim3
from .robust import check_convergence, solve_spd_small

N_ACC = 27
_THREADS = 256
_POINTS_PER_THREAD = 4
_MAX_BLOCKS = 1024
_SOLVE_OUT = 11     # gn_solve's result: T (8), ok, iterations run, last cost

# H (7x7) as entries of the 27 sums (slot 27 is a zero), with signs
# (gn_pallas.py:188-196); layout [t(3), w(3), s(1)]
_H_IDX = (
    (0, 1, 2, 27, 8, 7, 15),
    (1, 3, 4, 8, 27, 6, 16),
    (2, 4, 5, 7, 6, 27, 17),
    (27, 8, 7, 9, 10, 11, 27),
    (8, 27, 6, 10, 12, 13, 27),
    (7, 6, 27, 11, 13, 14, 27),
    (15, 16, 17, 27, 27, 27, 18),
)
_H_SIGN = (
    (1, 1, 1, 1, 1, -1, 1),
    (1, 1, 1, -1, 1, 1, 1),
    (1, 1, 1, 1, -1, 1, 1),
    (1, -1, 1, 1, 1, 1, 1),
    (1, 1, -1, 1, 1, 1, 1),
    (-1, 1, 1, 1, 1, 1, 1),
    (1, 1, 1, 1, 1, 1, 1),
)


class GNPointData:
    """The per-point inputs of one solve as one contiguous (9, n) f32 SoA
    tensor [xf, yf, zf, rkx, rky, rkz, rkd, w_ray, w_dist], built once and
    read by every GN iteration (gn_pallas.py:119).  No padding: the kernel
    masks the ragged end itself."""

    def __init__(self, Xf, rd_k_t, w_ray, w_dist):
        self.pts = torch.stack([
            Xf[:, 0], Xf[:, 1], Xf[:, 2],
            rd_k_t[0], rd_k_t[1], rd_k_t[2], rd_k_t[3],
            w_ray, w_dist,
        ]).to(torch.float32).contiguous()
        self.n = self.pts.shape[1]


def rot_scalars(T):
    """[R00..R22, tx, ty, tz, s] (13,) from a Sim(3) embedding (8,)
    (gn_pallas.py:153)."""
    Re = sim3.quat_rot_entries(T[3:7])
    return torch.stack([e for row in Re for e in row] +
                       [T[0], T[1], T[2], T[7]])


def gn_terms_plain(pts, scal, huber_k):
    """The 27 per-point terms (27, n) whose sums are the normal equations
    (gn_pallas.py:40-116)."""
    R00, R01, R02, R10, R11, R12, R20, R21, R22, tx, ty, tz, sc = \
        scal.unbind(0)
    xf, yf, zf, rkx, rky, rkz, rkd, w_ray, w_dist = pts.unbind(0)
    px = sc * (R00 * xf + R01 * yf + R02 * zf) + tx
    py = sc * (R10 * xf + R11 * yf + R12 * zf) + ty
    pz = sc * (R20 * xf + R21 * yf + R22 * zf) + tz
    d2 = px * px + py * py + pz * pz
    d = torch.sqrt(torch.clamp(d2, min=1e-24))
    dinv = 1.0 / d
    rx, ry, rz = px * dinv, py * dinv, pz * dinv
    ex, ey, ez, ed = rkx - rx, rky - ry, rkz - rz, rkd - d
    e2 = ex * ex + ey * ey + ez * ez

    def huber(r):
        ra = torch.abs(r)
        return torch.where(ra < huber_k, torch.ones_like(ra),
                           huber_k / torch.clamp(ra, min=1e-12))

    w_r = huber(w_ray * torch.sqrt(e2)) * w_ray * w_ray
    w_d = huber(w_dist * ed) * w_dist * w_dist
    qxx, qyy, qzz = rx * rx, ry * ry, rz * rz
    qxy, qxz, qyz = rx * ry, rx * rz, ry * rz
    wrd2 = w_r * (dinv * dinv)
    wrd = w_r * dinv
    rTe = rx * ex + ry * ey + rz * ez
    rows = [
        wrd2 * (1 - qxx) + w_d * qxx,
        (w_d - wrd2) * qxy,
        (w_d - wrd2) * qxz,
        wrd2 * (1 - qyy) + w_d * qyy,
        (w_d - wrd2) * qyz,
        wrd2 * (1 - qzz) + w_d * qzz,
        wrd * rx,
        wrd * ry,
        wrd * rz,
        w_r * (1 - qxx),
        -w_r * qxy,
        -w_r * qxz,
        w_r * (1 - qyy),
        -w_r * qyz,
        w_r * (1 - qzz),
        w_d * px,
        w_d * py,
        w_d * pz,
        w_d * d2,
        w_r * (ex - rx * rTe) * dinv + w_d * ed * rx,
        w_r * (ey - ry * rTe) * dinv + w_d * ed * ry,
        w_r * (ez - rz * rTe) * dinv + w_d * ed * rz,
        w_r * (ry * ez - rz * ey),
        w_r * (rz * ex - rx * ez),
        w_r * (rx * ey - ry * ex),
        w_d * ed * d,
        w_r * e2 + w_d * ed * ed,
    ]
    return torch.stack(rows)


def gn_sums_plain(pts, scal, huber_k):
    """The 27 sums in torch: the kernel's plain version and the CPU path."""
    return gn_terms_plain(pts, scal, huber_k).sum(dim=1)


def _lib():
    lib = _build.load("gn")
    fn = lib.gn_accumulate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gn_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def num_blocks(n: int) -> int:
    """Stage-1 grid size: fixed for a given n, so the fold order (and the
    result) is the same on every launch."""
    per_block = _THREADS * _POINTS_PER_THREAD
    return max(1, min(-(-n // per_block), _MAX_BLOCKS))


def _check_points(pts, what):
    if pts.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {pts.device}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[0] != 9 \
            or not pts.is_contiguous() or pts.shape[1] < 1:
        raise ValueError(f"{what} kernel takes a contiguous (9, n) f32 "
                         f"tensor")


def gn_sums(pts, scal, huber_k):
    """The 27 sums (27,) f32.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/gn.cu`` or raise."""
    if pts.device.type == "cpu":
        return gn_sums_plain(pts, scal, huber_k)
    _check_points(pts, "gn_sums")
    scal = scal.to(device=pts.device, dtype=torch.float32,
                   non_blocking=True).contiguous()
    if scal.shape != (13,):
        raise ValueError(f"gn_sums: scal must be (13,), got "
                         f"{tuple(scal.shape)}")
    n = pts.shape[1]
    G = num_blocks(n)
    partial = torch.empty((G, N_ACC), dtype=torch.float32, device=pts.device)
    out = torch.empty((N_ACC,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        err = _lib().gn_accumulate(
            pts.data_ptr(), n, scal.data_ptr(), float(huber_k),
            partial.data_ptr(), G, out.data_ptr(),
            torch.cuda.current_stream(pts.device).cuda_stream)
    _build.check(err, "gn_accumulate")
    _build.count_launch(gn_sums)
    return out


gn_sums.launches = 0


_H_IDX_T = torch.tensor(_H_IDX)
_H_SIGN_T = torch.tensor(_H_SIGN, dtype=torch.float32)


def assemble(a):
    """(27,) f32 sums on the host -> (H (7, 7), g (7,), cost ())
    (gn_pallas.py:177-197)."""
    H = torch.cat([a, a.new_zeros(1)])[_H_IDX_T] * _H_SIGN_T
    return H, a[19:26], 0.5 * a[26]


def gn_accumulate_plain(pre: GNPointData, T, huber_k):
    """Plain-torch (H, g, cost) at pose T, on the host."""
    scal = rot_scalars(T).to(pre.pts.device)
    return assemble(gn_sums_plain(pre.pts, scal, huber_k).cpu())


def gn_accumulate(pre: GNPointData, T, huber_k):
    """One fused pass: (H (7, 7), g (7,), cost ()) for the ray+dist closed
    form at pose T (gn_pallas.py:159).  The pose scalars are made where T
    lives (the host, in the tracker) and reach the card without a sync; the
    27 sums are the one copy back to the host, where H, g and cost are
    assembled."""
    scal = rot_scalars(T)
    return assemble(gn_sums(pre.pts, scal, huber_k).cpu())


def gn_loop(normal_equations, T_init, cfg):
    """The GN iteration on the host (the ``while_loop`` of
    tracker.py:363-374): ``normal_equations(T)`` gives (H, g, cost) on the
    host for the pose T (8,) f32 on the host; the 7x7 solve, the retraction
    and the convergence test run there in f32.  ``cfg`` carries
    ``max_iters``, ``rel_error`` and ``delta_norm``.  Returns (T on
    T_init's device, ok, iterations run)."""
    T = T_init.detach().to("cpu", torch.float32)
    old_cost = math.inf
    ok = True
    it = 0
    while it < cfg.max_iters:
        H, g, cost = normal_equations(T)                    # host: the sync
        tau, spd_ok = solve_spd_small(H, g)
        solve_ok = bool(spd_ok) and bool(torch.isfinite(tau).all())
        if not solve_ok:
            tau = torch.zeros_like(tau)
        conv = bool(check_convergence(cfg.rel_error, cfg.delta_norm,
                                      old_cost, cost, tau))
        if solve_ok:
            T = sim3.retr(T, tau)
        old_cost = cost
        ok = ok and solve_ok
        it += 1
        if conv or not solve_ok:
            break
    return T.to(T_init.device), ok, it


def gn_solve_plain(pre: GNPointData, T_init, cfg):
    """The whole solve in plain torch: the host loop over the plain sums, one
    sync per iteration.  The kernel's plain version and the CPU path."""
    return gn_loop(lambda T: gn_accumulate_plain(pre, T, cfg.huber_k),
                   T_init, cfg)


def gn_solve_launch(pts, T_init, cfg):
    """Launch the cooperative kernel on the current stream; returns its
    device buffer [T (8), ok, iterations run, last cost] without a sync."""
    T0 = T_init.detach().to(device=pts.device, dtype=torch.float32,
                            non_blocking=True).contiguous()
    scratch = torch.empty((2, _MAX_BLOCKS, N_ACC), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((_SOLVE_OUT,), dtype=torch.float32, device=pts.device)
    dev = pts.device
    with torch.cuda.device(dev):
        err = _lib().gn_solve(
            pts.data_ptr(), pts.shape[1], T0.data_ptr(), float(cfg.huber_k),
            float(cfg.rel_error), float(cfg.delta_norm), int(cfg.max_iters),
            scratch.data_ptr(), _MAX_BLOCKS, out.data_ptr(),
            torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gn_solve")
    _build.count_launch(gn_solve)
    return out


def gn_solve(pre: GNPointData, T_init, cfg):
    """The whole joint-ray-Huber solve from ``T_init`` (8,) (tracker.py:343-
    374): (T on T_init's device, ok, iterations run).  CPU points take the
    plain version; CUDA points launch the cooperative kernel of
    ``csrc/gn.cu`` once, or raise, and its small result buffer is the one
    copy back to the host."""
    pts = pre.pts
    if pts.device.type == "cpu":
        return gn_solve_plain(pre, T_init, cfg)
    _check_points(pts, "gn_solve")
    if T_init.shape != (8,):
        raise ValueError(f"gn_solve: T_init must be (8,), got "
                         f"{tuple(T_init.shape)}")
    out = gn_solve_launch(pts, T_init, cfg)
    host = out.cpu()                                        # the one sync
    T = out[:8] if T_init.device == pts.device else host[:8].to(T_init.device)
    return T.to(T_init.dtype), bool(host[8]), int(host[9])


gn_solve.launches = 0
