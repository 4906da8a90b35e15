"""Edge- and map-sharded Gauss-Newton bundle adjustment
(``parallel/sharded_ba.py``).

The factor graph's edges, the expensive part of a GN iteration (the
per-edge normal equations over every pixel), are split over the mesh's
``edge`` axis.  Each entry accumulates its edges' 14x14 blocks and
assembles its own dense (7F x 7F) pose system; the one collective of an
iteration is the reduction of (H, g), packed in one tensor
(``mesh.reduce_sum``: a fixed-order sum in one process, ``all_reduce``
across processes).  The Cholesky solve, the Sim(3) retraction and the
stopping test then run once on the reduced system, so every entry and
every process holds the same poses.  The pieces are the single-device
solver's (``ops/ba.py``: ``_pregather_edges``, ``_accumulate_pre``,
``_incidence`` / ``_assemble_with``, ``_solve_scaled``,
``subsample_points``), and so are the iteration count and the stopping
rule (``gauss_newton_from_pre``).

Map mode also splits the keyframe pointmaps over the ``edge`` axis: an
entry gathers, for every edge, the pixel rows of the endpoints it owns
(zeros elsewhere), and one reduce-scatter per side, before the loop,
leaves each entry its edges' rows; the loop is then the edge-sharded one.
There is no kernel here: JAX runs this part through XLA and
``jnp.linalg.cholesky``, as the port's ``ops/ba.py`` runs it through
PyTorch.
"""

from __future__ import annotations

import torch

from ..ops import ba
from ..ops import lie_sim3 as sim3
from ..ops.ba import EdgeData, sqrt_rn
from .mesh import Mesh, edge_shards, reduce_scatter, reduce_sum, replicate


def _two(A):
    return A[..., 0] if A.dim() == 3 else A


def _shard_constants(shards, Twc, K, cfg: ba.BAConfig):
    """Each entry's incidence matrix (``ops.ba._incidence``) and copy of K,
    built once per solve."""
    P = Twc.shape[0]
    return ([ba._incidence(ii, jj, P, cfg.pin, Twc.dtype)
             for _, ii, jj, _ in shards],
            [K.to(dev) for dev, _, _, _ in shards])


def _reduced_system(mesh: Mesh, Twc, shards, Ss, Ks, residual_type: str,
                    img_wh, cfg: ba.BAConfig):
    """The dense (7F x 7F) pose system at ``Twc``: each entry's (H, g) from
    its edge shard, packed in one tensor and reduced over the edge axis
    once.  Returns (H, g) on the reduction's device."""
    Fr = Twc.shape[0] - cfg.pin
    parts = []
    for (dev, ii, jj, pre), S, Kd, T in zip(shards, Ss, Ks,
                                            replicate(mesh, Twc)):
        Hs, gs = ba._accumulate_pre(residual_type, T, ii, jj, pre, Kd,
                                    img_wh, cfg)
        H, g = ba._assemble_with(S, Hs, gs)
        parts.append(torch.cat([H.reshape(-1), g]))
    Hg = reduce_sum(mesh, parts)
    return Hg[:Fr * Fr * 49].reshape(7 * Fr, 7 * Fr), Hg[Fr * Fr * 49:]


def _sharded_loop(mesh: Mesh, Twc, shards, K, residual_type: str, img_wh,
                  cfg: ba.BAConfig, return_stats: bool):
    """The GN loop over the entries' edge shards ``shards`` = [(device, ii,
    jj, EdgeData)] (sharded_ba.py:70-107): each entry's (H, g) at the
    current poses, one reduction of both, one solve.  At most
    ``cfg.max_iters`` iterations; it leaves after the one whose |dx| is
    under ``cfg.delta_norm`` or whose solve failed (a failed solve keeps
    the poses); one host read of two flags per iteration.  The poses stay
    on the reduction's device (the first entry's)."""
    Fr = Twc.shape[0] - cfg.pin
    Ss, Ks = _shard_constants(shards, Twc, K, cfg)
    delta = torch.full((), float("inf"))
    it, ok = 0, True
    while it < cfg.max_iters:
        H, g = _reduced_system(mesh, Twc, shards, Ss, Ks, residual_type,
                               img_wh, cfg)
        Twc = Twc.to(H.device)
        dx, solve_ok = ba._solve_scaled(H, g, cfg.damping)
        dx = -dx
        zeros_pin = torch.zeros((cfg.pin, 7), dtype=Twc.dtype,
                                device=Twc.device)
        Twc_new = sim3.retr(Twc, torch.cat([zeros_pin, dx.reshape(Fr, 7)]))
        delta = torch.linalg.norm(dx)
        Twc = torch.where(solve_ok, Twc_new, Twc)
        it += 1
        converged, solve_ok = torch.stack(
            [delta < cfg.delta_norm, solve_ok]).tolist()
        ok = ok and solve_ok
        if converged or not solve_ok:
            break
    if return_stats:
        return Twc, it, delta, ok
    return Twc


def _edge_shards(mesh: Mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                 edge_valid, cfg: ba.BAConfig, img_wh):
    """Each local entry's (device, ii, jj, EdgeData): its block of the
    edges, pregathered from the whole poses' pointmaps."""
    Cs2, vm2, Q2 = _two(Cs), _two(valid_match), _two(Q)
    C = min(cfg.chunk_points, idx_ii2jj.shape[1])
    shards = []
    for (e, dev), ii_l, jj_l, idx_l, vm_l, Q_l, ev_l in zip(
            mesh.local_edge_entries(),
            *(edge_shards(mesh, a) for a in (ii, jj, idx_ii2jj, vm2, Q2,
                                             edge_valid))):
        pre = ba._pregather_edges(Xs.to(dev), Cs2.to(dev), ii_l, jj_l, idx_l,
                                  vm_l, Q_l, ev_l, cfg, C, img_wh)
        shards.append((dev, ii_l, jj_l, pre))
    return shards


def sharded_gauss_newton(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj,
                         valid_match, Q, edge_valid, K, residual_type: str,
                         img_wh, cfg: ba.BAConfig,
                         return_stats: bool = False):
    """``ops.ba.gauss_newton`` with the edges split over the mesh's
    ``edge`` axis (sharded_ba.py:37).  Inputs as there; the edge-indexed
    arrays' length must divide over the axis (pad with ``edge_valid``
    False rows).  Poses and pointmaps go whole to every entry; each entry
    pregathers its own edges once, before the loop.  Returns Twc' (on the
    first entry's device) or, with ``return_stats``, (Twc', iterations,
    |dx|, ok) as ``gauss_newton``."""
    shards = _edge_shards(mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                          edge_valid, cfg, img_wh)
    return _sharded_loop(mesh, Twc, shards, K, residual_type, img_wh, cfg,
                         return_stats)


def sharded_gauss_newton_mapshard(mesh: Mesh, Twc, Xs, Cs, ii, jj,
                                  idx_ii2jj, valid_match, Q, edge_valid, K,
                                  residual_type: str, img_wh,
                                  cfg: ba.BAConfig,
                                  return_stats: bool = False):
    """Keyframe-axis (map) sharded GN (sharded_ba.py:109): the loop of
    ``sharded_gauss_newton`` on the shards of ``_map_shards``.  Both P and
    the edge count must divide over the axis."""
    shards = _map_shards(mesh, Twc.shape[0], Xs, Cs, ii, jj, idx_ii2jj,
                         valid_match, Q, edge_valid, cfg, img_wh)
    return _sharded_loop(mesh, Twc, shards, K, residual_type, img_wh, cfg,
                         return_stats)


def _map_shards(mesh: Mesh, P_n: int, Xs, Cs, ii, jj, idx_ii2jj,
                valid_match, Q, edge_valid, cfg: ba.BAConfig, img_wh):
    """Each local entry's (device, ii, jj, EdgeData) in map mode
    (sharded_ba.py:157-225): entry d holds keyframes ``[d * P/D,
    (d + 1) * P/D)`` of ``Xs`` / ``Cs`` and gathers, for every edge whose
    endpoint it owns, that endpoint's pixel rows (the i side permuted by
    ``idx_ii2jj`` as ``ops.ba._pregather_edges`` does, the j side in
    raster order), zeros elsewhere; one reduce-scatter per side leaves
    entry e the rows of its edge block e; the static gates and the chunk
    padding follow."""
    D = mesh.shape["edge"]
    E = ii.shape[0]
    if P_n % D or E % D:
        raise ValueError(f"map-sharded BA needs P ({P_n}) and E ({E}) "
                         f"divisible by the edge axis ({D})")
    Pl = P_n // D
    Nx = Xs.shape[1]
    Cs2, vm2, Q2 = _two(Cs), _two(valid_match), _two(Q)
    s = max(int(cfg.points_subsample), 1)
    # the balanced stride-s subset of the per-point edge arrays up front;
    # the index values stay full-resolution
    idx_s = ba.subsample_points(idx_ii2jj, s, img_wh)
    vm_s = ba.subsample_points(vm2, s, img_wh)
    Q_s = ba.subsample_points(Q2, s, img_wh)
    ind = torch.where(vm_s, idx_s, torch.zeros_like(idx_s))

    # stage 1: owner-side gathers over the full edge list
    parts_i, parts_j = [], []
    for d, dev in mesh.local_edge_entries():
        kf0 = d * Pl
        ii_d, jj_d, ind_d = ii.to(dev).long(), jj.to(dev).long(), \
            ind.to(dev).long()
        X_loc = Xs[kf0:kf0 + Pl].to(dev)
        C_loc = Cs2[kf0:kf0 + Pl].to(dev)
        own_i = (ii_d >= kf0) & (ii_d < kf0 + Pl)
        own_j = (jj_d >= kf0) & (jj_d < kf0 + Pl)
        li = torch.clamp(ii_d - kf0, 0, Pl - 1)
        lj = torch.clamp(jj_d - kf0, 0, Pl - 1)
        src = torch.cat([X_loc.reshape(Pl * Nx, 3),
                         C_loc.reshape(Pl * Nx, 1)], dim=-1)
        gi = src[li[:, None] * Nx + ind_d]                        # (E, Ns, 4)
        gj = torch.cat([ba.subsample_points(X_loc[lj], s, img_wh),
                        ba.subsample_points(C_loc[lj], s, img_wh)[..., None]],
                       dim=-1)
        zero = gi.new_zeros(())
        parts_i.append(torch.where(own_i[:, None, None], gi, zero))
        parts_j.append(torch.where(own_j[:, None, None], gj, zero))

    # stage 2: one reduce-scatter per side -> each entry's edge block
    gis = reduce_scatter(mesh, parts_i)
    gjs = reduce_scatter(mesh, parts_j)

    # the pregather's epilogue on each block (sharded_ba.py:205-225)
    C = min(cfg.chunk_points, Nx)
    shards = []
    for (e, dev), gi, gj, ii_l, jj_l, vm_l, Q_l, ev_l, ind_l in zip(
            mesh.local_edge_entries(), gis, gjs,
            *(edge_shards(mesh, a) for a in (ii, jj, vm_s, Q_s, edge_valid,
                                             ind))):
        ci, cj = gi[..., 3], gj[..., 3]
        Xi = gi[..., :3].transpose(1, 2)
        Xj = gj[..., :3].transpose(1, 2)
        static_valid = (vm_l & (Q_l > cfg.Q_conf) & (ci > cfg.C_conf)
                        & (cj > cfg.C_conf) & ev_l[:, None])
        sqw = torch.where(static_valid, sqrt_rn(torch.clamp(Q_l, min=0.0)),
                          torch.zeros_like(Q_l))
        pad = (-Xi.shape[-1]) % C
        Xi, Xj, sqw, ind_l = (torch.nn.functional.pad(A, (0, pad)) if pad
                              else A for A in (Xi, Xj, sqw, ind_l))
        pre = EdgeData(Xi.contiguous(), Xj.contiguous(), sqw.contiguous(),
                       ind_l.contiguous())
        shards.append((dev, ii_l, jj_l, pre))
    return shards


def sharded_normal_equations(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj,
                             valid_match, Q, edge_valid, K,
                             residual_type: str, img_wh, cfg: ba.BAConfig,
                             shard_mode: str = "edge"):
    """The reduced pose system (H, g) of the first GN iteration at ``Twc``
    in ``shard_mode``: what the single-device solver assembles, summed
    over the entries instead (a check of the reduction that does not pass
    through the solve's conditioning)."""
    if shard_mode == "edge":
        shards = _edge_shards(mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                              Q, edge_valid, cfg, img_wh)
    else:
        shards = _map_shards(mesh, Twc.shape[0], Xs, Cs, ii, jj, idx_ii2jj,
                             valid_match, Q, edge_valid, cfg, img_wh)
    return _reduced_system(mesh, Twc, shards,
                           *_shard_constants(shards, Twc, K, cfg),
                           residual_type, img_wh, cfg)
