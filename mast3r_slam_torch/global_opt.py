"""Factor graph and the global pointmap bundle adjustment around it.

Mirrors ``mast3r_slam_tpu/global_opt.py``: the edge store, ``add_factors``
(symmetric decode + match with two-directional gating, or the consecutive
edge completed from the tracker's reused match), the incremental pregather
cache and ``solve_poses`` for the ray and calibrated residuals.

The edge store lives on the engine's device with JAX's dtypes: int32
match indices (cast to int64 where they index), bool masks, f32 weights.
JAX drops an out-of-range scatter row and clamps an out-of-range gather;
PyTorch raises on the CPU and asserts on the card, so every place that
relies on it takes an explicit mask (``_write_edges``, the pose write-back
of ``frame.arena_update_poses``, the padded rows of ``_rows``).  The
buckets JAX pads to for its compile cache are kept where they shape a
result (the edge and pose buckets of a solve, so ``solve_poses`` returns
JAX's ``upd``), and dropped where they only batch work (the symmetric
match and the cache refresh run on the real rows).

Retrieval edges between keyframes whose q8 descriptor tables are stored
(``retrieval_edge_mode: desc_global``) are matched pose-free from those
tables (``ops/matching.py::match_desc_global``), and the pairs its gates
reject are retried through the symmetric decode.

Multi-device: with ``device`` / ``params`` the edge store lives on a
backend device and the backend's decodes run through that device's copy of
the engine; with ``mesh`` the BA solve is sharded over the mesh's ``edge``
axis (``parallel/sharded_ba.py``: the edges, or in ``shard_mode`` "map"
the keyframe pointmaps too).
"""

from __future__ import annotations

import numpy as np
import torch

from .frame import KeyframeArena, arena_update_poses
from .ops import ba
from .parallel.sharded_ba import (sharded_gauss_newton,
                                  sharded_gauss_newton_mapshard)
from .ops import matching as matching_ops
from .ops.ba import sqrt_rn
from .ops.geometry import constrain_points_to_ray


def _next_bucket(n: int, minimum: int = 1) -> int:
    """(global_opt.py:36)"""
    b = minimum
    while b < n:
        b *= 2
    return b


def _rows(a, n: int):
    """The first n rows of a, zero rows appended past its end (JAX's
    dynamic slice of a padded bucket)."""
    if n <= a.shape[0]:
        return a[:n]
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def _write_edges(stores, slots, news):
    """Row writes into the edge arrays, in place (global_opt.py:43): row b
    of each new array goes to ``slots[b]``, a host array; a slot past the
    store's end marks a rejected edge, whose row is dropped."""
    slots = np.asarray(slots, np.int64)
    keep = np.nonzero(slots < stores[0].shape[0])[0]
    if not len(keep):
        return
    dev = stores[0].device
    dst = torch.from_numpy(slots[keep]).to(dev)
    src = torch.from_numpy(keep).to(dev)
    for store, new in zip(stores, news):
        store[dst] = new.to(dev).index_select(0, src).to(store.dtype)


def _frac(valid):
    """Share of valid pixels per row, rounded as ``jnp.mean`` rounds it:
    the exact count times the f32 reciprocal of the row length
    (``Tensor.mean`` divides, one ulp away in some rows)."""
    return valid.sum(dim=1).float() * (1.0 / valid.shape[1])


def _gather_q(Q_src, idx):
    return torch.gather(Q_src[..., 0], 1, idx.long())


def _gate_edges(idx_i2j, idx_j2i, valid_match_j, valid_match_i,
                Qii, Qjj, Qji, Qij, Q_conf):
    """Per-edge confidence products and the two directions' match
    fractions (global_opt.py:60)."""
    Qj = sqrt_rn(_gather_q(Qii, idx_i2j) * Qji[..., 0])
    Qi = sqrt_rn(_gather_q(Qjj, idx_j2i) * Qij[..., 0])
    valid_j = valid_match_j[..., 0] & (Qj > Q_conf)
    valid_i = valid_match_i[..., 0] & (Qi > Q_conf)
    return Qj, Qi, _frac(valid_j), _frac(valid_i)


def _sub2(A, h, w):
    """(B, h*w, ...) -> its (::2, ::2) grid, flattened."""
    B = A.shape[0]
    return A.reshape((B, h, w) + A.shape[2:])[:, ::2, ::2].reshape(
        (B, -1) + A.shape[2:])


def _expand2(A, fill, h, w):
    """A subgrid array (B, (h/2)*(w/2), ...) scattered to full size
    (B, h*w, ...) at the even pixels, ``fill`` elsewhere."""
    B, rest = A.shape[0], tuple(A.shape[2:])
    out = torch.full((B, h // 2, 2, w // 2, 2) + rest, fill, dtype=A.dtype,
                     device=A.device)
    out[:, :, 0, :, 0] = A.reshape((B, h // 2, w // 2) + rest)
    return out.reshape((B, h * w) + rest)


def _gate_edges_sub(idx_i2j, idx_j2i, valid_match_j, valid_match_i,
                    Qii, Qjj, Qji, Qij, Q_conf, h, w):
    """``_gate_edges`` for subgrid edge matches (edge_query_subsample 2,
    global_opt.py:76): the weights and match fractions on the (::2, ::2)
    grid, the outputs scattered to full size with the odd pixels invalid,
    which is exactly what BA reads at points_subsample 4."""
    Qj_s = sqrt_rn(_gather_q(Qii, idx_i2j) * _sub2(Qji[..., 0], h, w))
    Qi_s = sqrt_rn(_gather_q(Qjj, idx_j2i) * _sub2(Qij[..., 0], h, w))
    valid_j = valid_match_j[..., 0] & (Qj_s > Q_conf)
    valid_i = valid_match_i[..., 0] & (Qi_s > Q_conf)
    return (
        _expand2(idx_i2j, 0, h, w), _expand2(idx_j2i, 0, h, w),
        _expand2(valid_match_j, False, h, w),
        _expand2(valid_match_i, False, h, w),
        _expand2(Qj_s, 0.0, h, w), _expand2(Qi_s, 0.0, h, w),
        _frac(valid_j), _frac(valid_i),
    )


def _dir_weight(idx, Q_src, Q_res):
    """One direction's full-grid edge weight (global_opt.py:116)."""
    return sqrt_rn(_gather_q(Q_src, idx) * Q_res[..., 0])


def _dir_weight_sub(idx, vm, Q_src, Q_res, h, w):
    """One direction's weight for a subgrid match, scattered to full size
    like ``_gate_edges_sub`` (global_opt.py:124)."""
    Qd = sqrt_rn(_gather_q(Q_src, idx) * _sub2(Q_res[..., 0], h, w))
    return (_expand2(idx, 0, h, w), _expand2(vm, False, h, w),
            _expand2(Qd, 0.0, h, w))


def _compact_points(X_arena, C_arena, N_arena, uidx, K, img_wh, use_calib):
    """The keyframes ``uidx`` (a device index): points, on their pixel rays
    in the calibrated mode, and average confidences (P, N)."""
    Xs = X_arena[uidx]
    Cs = C_arena[uidx, :, 0] / torch.clamp(N_arena[uidx], min=1)[:, None]
    if use_calib:
        w, h = img_wh
        Xs = constrain_points_to_ray((h, w), Xs, K)
    return Xs, Cs


def _prep_system(X_arena, C_arena, N_arena, T_arena,
                 idx_ii2jj, idx_jj2ii, vmj, vmi, Qj_arr, Qi_arr,
                 uidx, K, E_bucket, img_wh, use_calib):
    """The two-way system over the first E_bucket edge rows and the compact
    pose and point set (global_opt.py:154)."""
    def two(a, b):
        return torch.cat([_rows(a, E_bucket), _rows(b, E_bucket)])

    Xs, Cs = _compact_points(X_arena, C_arena, N_arena, uidx, K, img_wh,
                             use_calib)
    return (T_arena[uidx], Xs, Cs, two(idx_ii2jj, idx_jj2ii), two(vmj, vmi),
            two(Qj_arr, Qi_arr))


def _prep_and_solve(X_arena, C_arena, N_arena, T_arena,
                    idx_ii2jj, idx_jj2ii, vmj, vmi, Qj_arr, Qi_arr,
                    uidx, ii2, jj2, edge_valid, K, E_bucket: int,
                    residual_type: str, img_wh, cfg: ba.BAConfig,
                    use_calib: bool):
    """Prep + GN solve without the cache (global_opt.py:181)."""
    Twc, Xs, Cs, idx2, vm2, Q2 = _prep_system(
        X_arena, C_arena, N_arena, T_arena, idx_ii2jj, idx_jj2ii, vmj, vmi,
        Qj_arr, Qi_arr, uidx, K, E_bucket, img_wh, use_calib)
    return ba.gauss_newton(Twc, Xs, Cs, ii2, jj2, idx2, vm2, Q2, edge_valid,
                           K, residual_type, img_wh, cfg)


def _prep_and_solve_sharded(X_arena, C_arena, N_arena, T_arena,
                            idx_ii2jj, idx_jj2ii, vmj, vmi, Qj_arr, Qi_arr,
                            uidx, ii2, jj2, edge_valid, K, mesh,
                            shard_mode: str, E_bucket: int,
                            residual_type: str, img_wh, cfg: ba.BAConfig,
                            use_calib: bool):
    """Prep + GN solve sharded over the mesh's ``edge`` axis
    (global_opt.py:280): ``shard_mode`` "edge" splits the edges
    (``sharded_gauss_newton``), "map" the keyframe pointmaps too
    (``sharded_gauss_newton_mapshard``).  The poses come back on the mesh's
    first entry's device."""
    Twc, Xs, Cs, idx2, vm2, Q2 = _prep_system(
        X_arena, C_arena, N_arena, T_arena, idx_ii2jj, idx_jj2ii, vmj, vmi,
        Qj_arr, Qi_arr, uidx, K, E_bucket, img_wh, use_calib)
    fn = sharded_gauss_newton if shard_mode == "edge" else \
        sharded_gauss_newton_mapshard
    return fn(mesh, Twc, Xs, Cs, ii2, jj2, idx2, vm2, Q2, edge_valid, K,
              residual_type, img_wh, cfg, return_stats=True)


def _prep_and_solve_cached(X_arena, T_arena, pre_Xi_f, pre_sqw_f, pre_ind_f,
                           pre_Xi_r, pre_sqw_r, pre_ind_r, uidx, ii2, jj2, K,
                           E_bucket: int, residual_type: str, img_wh,
                           cfg: ba.BAConfig, use_calib: bool):
    """GN solve on the pregather cache (global_opt.py:202): the permuted
    i side comes from the cache, the raster j side and the poses are
    gathered per solve.  Unoccupied cache rows have zero weight."""
    s = max(int(cfg.points_subsample), 1)

    def two(a, b):
        return torch.cat([_rows(a, E_bucket), _rows(b, E_bucket)])

    Xi2 = two(pre_Xi_f, pre_Xi_r)
    sqw2 = two(pre_sqw_f, pre_sqw_r)
    ind2 = two(pre_ind_f, pre_ind_r)
    Xs = X_arena[uidx]
    if use_calib:
        w, h = img_wh
        Xs = constrain_points_to_ray((h, w), Xs, K)
    Xj2 = ba.subsample_points(Xs[jj2], s, img_wh).transpose(1, 2)
    pad = Xi2.shape[-1] - Xj2.shape[-1]
    if pad:
        Xj2 = torch.nn.functional.pad(Xj2, (0, pad))
    pre = ba.EdgeData(Xi2, Xj2.contiguous(), sqw2, ind2)
    return ba.gauss_newton_from_pre(T_arena[uidx], pre, ii2, jj2, K,
                                    residual_type, img_wh, cfg)


def _refresh_pre_rows(pres, X_arena, C_arena, N_arena, K, stores, slots,
                      uidx_r, ii_l, jj_l, img_wh, cfg: ba.BAConfig,
                      use_calib: bool):
    """Recompute the cached pregather rows of the edge slots ``slots``
    (global_opt.py:241), in place.  ``pres`` = (Xi, sqw, ind) forward then
    reverse; ``stores`` the six edge arrays; ``uidx_r`` / ``ii_l`` /
    ``jj_l`` the batch's compact keyframe set and its endpoints in it.
    JAX pads the batch to a bucket with slots past the store, dropped by
    its scatter; here the batch is the real slots."""
    idx_f, idx_r, vmj, vmi, Qj_arr, Qi_arr = stores
    Xs, Cs = _compact_points(X_arena, C_arena, N_arena, uidx_r, K, img_wh,
                             use_calib)
    ev = torch.ones((len(slots),), dtype=torch.bool, device=Xs.device)
    C = min(cfg.chunk_points, idx_f.shape[1])
    pre_f = ba._pregather_edges(Xs, Cs, ii_l, jj_l, idx_f[slots], vmj[slots],
                                Qj_arr[slots], ev, cfg, C, img_wh)
    pre_r = ba._pregather_edges(Xs, Cs, jj_l, ii_l, idx_r[slots], vmi[slots],
                                Qi_arr[slots], ev, cfg, C, img_wh)
    for store, new in zip(pres, (pre_f.Xi, pre_f.sqw, pre_f.ind,
                                 pre_r.Xi, pre_r.sqw, pre_r.ind)):
        store[slots] = new.to(store.dtype)


class FactorGraph:
    """The factor graph over the keyframe arena (global_opt.py:309), driven
    from the host."""

    def __init__(self, engine, hw: int, cfg: dict, K=None, device=None,
                 params=None, mesh=None, shard_mode: str = "edge",
                 store_device=None):
        """``store_device``: where the edge store lives (default
        ``engine.device``; the arena's device in the pipeline).

        ``device`` / ``params`` (global_opt.py:315-339): the backend device
        of the frontend / backend split; the edge store lives there, and the
        symmetric and asymmetric decodes of ``add_factors`` run through
        ``params``, that device's copy of the engine (the counterpart of
        JAX's copy of the weights; ``engine`` itself when None).

        ``mesh``: a ``parallel.mesh.Mesh`` with an ``edge`` axis; the BA
        solve then runs sharded over it (``shard_mode`` "edge" or "map"),
        without the pregather cache, and the store defaults to the mesh's
        first entry's device.  Exclusive with ``device``."""
        if mesh is not None and device is not None:
            raise ValueError(
                "FactorGraph: mesh-sharded BA and backend-device placement "
                "are mutually exclusive (the sharded solve spans all the "
                "mesh's devices; run it on the whole mesh instead)")
        if shard_mode not in ("edge", "map"):
            raise ValueError(f"shard_mode must be 'edge' or 'map', got "
                             f"{shard_mode!r}")
        self.engine = engine
        # the engine the backend's decodes and matches run through
        self._eng = params if params is not None else engine
        self.mesh = mesh
        self.shard_mode = shard_mode
        self._mesh_D = int(mesh.shape["edge"]) if mesh is not None else 1
        if device is not None:
            store_device = device
        elif store_device is None and mesh is not None:
            store_device = mesh.devices[0, 0]
        if store_device is None:
            store_device = getattr(engine, "device", None)
            if store_device is None:
                raise ValueError("FactorGraph needs store_device or an "
                                 "engine with a device")
        self.dev = torch.device(store_device)
        self.cfg = ba.BAConfig.from_config(cfg)
        self.local_cfg = cfg["local_opt"]
        # decode-free pose-warped consecutive edge (_add_consecutive_reused)
        self.reuse_warp = bool(self.local_cfg.get("reuse_warp", True))
        # retrieval-edge matching: "sym" (symmetric decode + match) or
        # "desc_global" (pose-free matching of stored q8 tables)
        self.retrieval_edge_mode = str(
            self.local_cfg.get("retrieval_edge_mode", "sym"))
        self.desc_store: dict = {}
        # add_factors batches matched by desc_global, and the pairs of those
        # batches its gates rejected (retried through the symmetric decode)
        self.n_desc_batches = 0
        self.n_desc_fallbacks = 0
        try:
            self.match_cfg = getattr(engine, "match_cfg", None) or \
                matching_ops.MatchingConfig.from_dict(cfg["matching"])
        except (KeyError, TypeError):   # reduced test configs
            self.match_cfg = matching_ops.MatchingConfig()
        if self.match_cfg.edge_query_subsample != 2:
            # desc_global emits the edge_query_subsample 2 subgrid layout
            self.retrieval_edge_mode = "sym"
        self.max_edges = int(self.local_cfg.get("max_edges", 256))
        self.min_match_frac = float(self.local_cfg["min_match_frac"])
        self.hw = hw
        self.K = None if K is None else torch.as_tensor(
            np.asarray(K.cpu() if torch.is_tensor(K) else K),
            dtype=torch.float32).to(self.dev)
        self.use_calib = K is not None

        E = self.max_edges
        self.ii = np.zeros((E,), np.int32)
        self.jj = np.zeros((E,), np.int32)
        self.n_edges = 0
        z = dict(device=self.dev)
        self.idx_ii2jj = torch.zeros((E, hw), dtype=torch.int32, **z)
        self.idx_jj2ii = torch.zeros((E, hw), dtype=torch.int32, **z)
        self.valid_match_j = torch.zeros((E, hw), dtype=torch.bool, **z)
        self.valid_match_i = torch.zeros((E, hw), dtype=torch.bool, **z)
        self.Q_ii2jj = torch.zeros((E, hw), **z)
        self.Q_jj2ii = torch.zeros((E, hw), **z)

        # incremental pregather cache (local_opt.cache_pregather): keyframe
        # pointmaps do not change once a newer keyframe exists, so the
        # permuted-side gathers are kept per edge slot across rounds and
        # refreshed for edges that are new or whose endpoint changed
        # (arena.N_updates); off under a mesh, whose solvers pregather their
        # own shards (global_opt.py:403-405)
        self.cache_pre = bool(self.local_cfg.get("cache_pregather", True)) \
            and mesh is None
        if self.cache_pre:
            s = max(int(self.cfg.points_subsample), 1)
            n_sub = -(-hw // s)
            C = min(self.cfg.chunk_points, hw)
            self._Np = n_sub + (-n_sub % C)
            self._alloc_pre(E)
            self._pre_fresh = np.zeros((E,), bool)
            self._nupd_seen: dict = {}
            # residual mode the cached rows were built for
            self._pre_calib: bool | None = None

    # -- edge store -----------------------------------------------------

    def _stores(self):
        return (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j,
                self.valid_match_i, self.Q_ii2jj, self.Q_jj2ii)

    def _pres(self):
        return (self.pre_Xi_f, self.pre_sqw_f, self.pre_ind_f,
                self.pre_Xi_r, self.pre_sqw_r, self.pre_ind_r)

    def _alloc_pre(self, E: int):
        Np, z = self._Np, dict(device=self.dev)
        self.pre_Xi_f = torch.zeros((E, 3, Np), **z)
        self.pre_sqw_f = torch.zeros((E, Np), **z)
        self.pre_ind_f = torch.zeros((E, Np), dtype=torch.int32, **z)
        self.pre_Xi_r = torch.zeros((E, 3, Np), **z)
        self.pre_sqw_r = torch.zeros((E, Np), **z)
        self.pre_ind_r = torch.zeros((E, Np), dtype=torch.int32, **z)

    def _grow(self, needed: int):
        """Grow the edge store to the next power-of-two bucket >= needed
        (global_opt.py:430)."""
        E2 = _next_bucket(needed, self.max_edges * 2)
        pad = E2 - self.max_edges
        self.ii = np.concatenate([self.ii, np.zeros((pad,), np.int32)])
        self.jj = np.concatenate([self.jj, np.zeros((pad,), np.int32)])

        def grow(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

        (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j,
         self.valid_match_i, self.Q_ii2jj, self.Q_jj2ii) = map(
            grow, self._stores())
        if self.cache_pre:
            (self.pre_Xi_f, self.pre_sqw_f, self.pre_ind_f,
             self.pre_Xi_r, self.pre_sqw_r, self.pre_ind_r) = map(
                grow, self._pres())
            self._pre_fresh = np.concatenate(
                [self._pre_fresh, np.zeros((pad,), bool)])
        self.max_edges = E2

    def _append(self, ii, jj, accept, news):
        """Write the accepted rows of ``news`` into the next free slots
        (global_opt.py:596-611), growing the store first when they would
        pass its end; a rejected row carries a slot past the end."""
        accept = np.asarray(accept, bool)
        n_new = int(accept.sum())
        if self.n_edges + n_new > self.max_edges:
            self._grow(self.n_edges + n_new)
        slots = np.full((len(accept),), self.max_edges, np.int64)
        slots[accept] = self.n_edges + np.arange(n_new)
        _write_edges(self._stores(), slots, news)
        self.ii[self.n_edges:self.n_edges + n_new] = np.asarray(ii)[accept]
        self.jj[self.n_edges:self.n_edges + n_new] = np.asarray(jj)[accept]
        self.n_edges += n_new

    def store_desc(self, row: int, desc8, dconf, h: int, w: int):
        """Keep a keyframe's q8 descriptor table (1, h*w, f) and descriptor
        confidence (1, h*w, 1) for the desc_global matcher
        (global_opt.py:464); rows never change once stored."""
        if self.retrieval_edge_mode != "desc_global" or \
                row in self.desc_store:
            return
        self.desc_store[row] = (desc8.reshape(1, h, w, -1).to(self.dev),
                                dconf.float().reshape(1, h * w, 1)
                                .to(self.dev))

    def add_factors(self, arena: KeyframeArena, ii, jj, min_match_frac,
                    is_reloc: bool = False, reuse=None) -> bool:
        """Symmetric decode + match and two-directional gating
        (global_opt.py:478).  Returns True if an edge was added.
        ``reuse``: the tracker's frame -> keyframe direction of the
        consecutive edge {pair: (i, j), idx_j2i, valid_i, Qjj, Qij,
        desc8_frame, desc8_kf}; that edge is then completed by
        ``_add_consecutive_reused``."""
        if len(ii) == 0:
            return False
        if reuse is not None and not is_reloc:
            pi, pj = reuse["pair"]
            rest = [(a, b) for a, b in zip(ii, jj)
                    if (int(a), int(b)) != (pi, pj)]
            if len(rest) < len(ii):    # the pair is among the candidates
                added = self._add_consecutive_reused(arena, pi, pj, reuse)
                if rest:
                    ra = self.add_factors(
                        arena, [a for a, _ in rest], [b for _, b in rest],
                        min_match_frac, is_reloc)
                    added = added or ra
                return added
        ii = [int(a) for a in ii]
        jj = [int(b) for b in jj]
        use_desc = (self.retrieval_edge_mode == "desc_global"
                    and not is_reloc
                    and all(r in self.desc_store for r in set(ii) | set(jj)))
        if use_desc:
            # one match_desc_global call per edge (global_opt.py:514-546);
            # JAX pads the batch to a bucket and drops the padded rows
            self.n_desc_batches += 1
            h, w = arena.img_hw
            per = [matching_ops.match_desc_global(
                self.desc_store[a][0], self.desc_store[b][0],
                self.desc_store[a][1], self.desc_store[b][1], h, w,
                self.match_cfg) for a, b in zip(ii, jj)]
            (idx_i2j, idx_j2i, valid_match_j, valid_match_i,
             Qii, Qjj, Qji, Qij) = (torch.cat([p[k] for p in per])
                                    for k in range(8))
        else:
            dev = arena.feat.device
            sel_i = torch.tensor(ii, device=dev)
            sel_j = torch.tensor(jj, device=dev)
            to = self._to_eng
            (idx_i2j, idx_j2i, valid_match_j, valid_match_i,
             Qii, Qjj, Qji, Qij) = self._eng.match_symmetric(
                to(arena.feat[sel_i]), to(arena.pos[sel_i]),
                to(arena.feat[sel_j]), to(arena.pos[sel_j]))
        if idx_i2j.shape[1] * 4 == Qii.shape[1]:
            # subgrid edge match: gate on the subgrid, store at full size
            h, w = arena.img_hw
            (idx_i2j, idx_j2i, valid_match_j, valid_match_i, Qj, Qi,
             match_frac_j, match_frac_i) = _gate_edges_sub(
                idx_i2j, idx_j2i, valid_match_j, valid_match_i,
                Qii, Qjj, Qji, Qij, self.cfg.Q_conf, h, w)
        else:
            Qj, Qi, match_frac_j, match_frac_i = _gate_edges(
                idx_i2j, idx_j2i, valid_match_j, valid_match_i,
                Qii, Qjj, Qji, Qij, self.cfg.Q_conf)
        ii_np, jj_np = np.asarray(ii), np.asarray(jj)
        # both directions must clear the threshold; consecutive edges are
        # always kept (global_opt.py:568-571)
        invalid = torch.minimum(match_frac_j, match_frac_i).cpu().numpy() \
            < min_match_frac
        invalid &= ii_np != jj_np - 1
        if invalid.any() and is_reloc:
            return False
        accept = ~invalid
        n_new = int(accept.sum())
        if use_desc and invalid.any():
            # the desc_global gates are conservative: retry only the
            # rejected pairs through the symmetric decode, whose edges are
            # written first (global_opt.py:576-592)
            self.n_desc_fallbacks += int(invalid.sum())
            ra = self._add_factors_sym(arena, list(ii_np[invalid]),
                                       list(jj_np[invalid]), min_match_frac)
            if n_new == 0:
                return ra
        if n_new == 0:
            return False
        self._append(ii_np, jj_np, accept,
                     (idx_i2j, idx_j2i, valid_match_j[..., 0],
                      valid_match_i[..., 0], Qj, Qi))
        return True

    def _add_factors_sym(self, arena: KeyframeArena, ii, jj,
                         min_match_frac) -> bool:
        """``add_factors`` through the symmetric decode, whatever the mode
        (global_opt.py:614): the desc_global rejection fallback."""
        mode = self.retrieval_edge_mode
        self.retrieval_edge_mode = "sym"
        try:
            return self.add_factors(arena, ii, jj, min_match_frac)
        finally:
            self.retrieval_edge_mode = mode

    def _add_consecutive_reused(self, arena: KeyframeArena, i: int, j: int,
                                reuse) -> bool:
        """The consecutive edge (i, j) from the tracker's reused j -> i
        direction and an i -> j match (global_opt.py:626), either
        pose-warped from the canonical pointmaps and the tracker's q8
        tables (decode-free; ``local_opt.reuse_warp``) or from a fresh
        asymmetric decode (an engine without ``match_arrays_warp``, such as
        the oracle)."""
        d8f = reuse.get("desc8_frame")
        d8k = reuse.get("desc8_kf")
        if self.reuse_warp and d8f is not None \
                and hasattr(self._eng, "match_arrays_warp"):
            # d8k = keyframe i's descriptors (the tracker's view 2), d8f =
            # keyframe j's (view 1)
            idx_i2j, vm_j = self._eng.match_arrays_warp(
                arena.X, arena.T_WC, i, j, d8k, d8f, arena.img_hw)
            # confidences of the same (j, i) decode, sides swapped
            Qii, Qji = reuse["Qij"], reuse["Qjj"]
        else:
            to = self._to_eng
            (idx_i2j, vm_j, _Xff, _Cff, Qii, _Xkf, _Ckf, Qji) = \
                self._eng.match_asymmetric(
                    to(arena.feat[i][None]), to(arena.pos[i][None]),
                    to(arena.feat[j][None]), to(arena.pos[j][None]))[:8]
        idx_j2i, vm_i = reuse["idx_j2i"], reuse["valid_i"]
        Qjj, Qij = reuse["Qjj"], reuse["Qij"]
        if idx_i2j.shape[1] * 4 == Qjj.shape[1]:
            # the warped direction matched on the edge subgrid; the reused
            # tracker direction stays full-grid
            h, w = arena.img_hw
            idx_i2j, vm_j, Qj = _dir_weight_sub(idx_i2j, vm_j, Qii, Qji, h, w)
            Qi = _dir_weight(idx_j2i, Qjj, Qij)
        else:
            Qj, Qi, _, _ = _gate_edges(idx_i2j, idx_j2i, vm_j, vm_i, Qii,
                                       Qjj, Qji, Qij, self.cfg.Q_conf)
        # consecutive edges are never rejected
        self._append([i], [j], [True],
                     (idx_i2j, idx_j2i, vm_j[..., 0], vm_i[..., 0], Qj, Qi))
        return True

    def _to_eng(self, t):
        """``t`` on the device of the engine the backend decodes with."""
        return t.to(getattr(self._eng, "device", t.device))

    # -- incremental pregather cache -------------------------------------

    def _sync_cache(self, arena: KeyframeArena, unique: np.ndarray,
                    calib: bool):
        """Refresh the cached rows of edges that are new or whose endpoint's
        pointmap changed since the last solve (global_opt.py:698)."""
        if calib != self._pre_calib:
            self._pre_fresh[:] = False
            self._pre_calib = calib
        nupd = arena.N_updates.cpu().numpy()
        changed = {int(k) for k in unique
                   if self._nupd_seen.get(int(k)) != int(nupd[int(k)])}
        dirty = [e for e in range(self.n_edges)
                 if not self._pre_fresh[e] or int(self.ii[e]) in changed
                 or int(self.jj[e]) in changed]
        if dirty:
            self._refresh_pre(arena, dirty, calib)
            self._pre_fresh[dirty] = True
        for k in unique:
            self._nupd_seen[int(k)] = int(nupd[int(k)])

    def _refresh_pre(self, arena: KeyframeArena, slots, calib: bool):
        """(global_opt.py:725)"""
        kfs = np.unique(np.concatenate([self.ii[slots], self.jj[slots]]))
        remap = {int(k): c for c, k in enumerate(kfs)}
        ii_l = [remap[int(self.ii[e])] for e in slots]
        jj_l = [remap[int(self.jj[e])] for e in slots]
        h, w = arena.img_hw
        dev = self.dev
        _refresh_pre_rows(
            self._pres(), arena.X, arena.C, arena.N, self._K(),
            self._stores(), torch.tensor(slots, device=dev),
            torch.from_numpy(kfs.astype(np.int64)).to(dev),
            torch.tensor(ii_l, device=dev), torch.tensor(jj_l, device=dev),
            (w, h), self.cfg, calib)

    def invalidate_cache(self):
        """Drop every cached row (global_opt.py:754)."""
        if self.cache_pre:
            self._alloc_pre(self.max_edges)
            self._pre_fresh[:] = False
            self._nupd_seen.clear()
            self._pre_calib = None

    # -- solves -----------------------------------------------------------

    def _K(self):
        return self.K if self.K is not None else \
            torch.eye(3, device=self.dev)

    def get_unique_kf_idx(self) -> np.ndarray:
        n = self.n_edges
        return np.unique(np.concatenate([self.ii[:n], self.jj[:n]]))

    def solve_poses(self, arena: KeyframeArena, residual_type: str):
        """The GN solve on ``arena`` without writing back
        (global_opt.py:774).  Returns (upd (P_pad,) int64 host array of
        arena rows, 1 << 30 for the pinned and padded ones; Twc_new
        (P_pad, 8); (iterations, |dx|, ok)), or None when there is nothing
        to solve."""
        pin = self.cfg.pin
        n = self.n_edges
        if n == 0:
            return None
        unique = self.get_unique_kf_idx()
        P = len(unique)
        if P <= pin:
            return None
        # sharded: the 2 * E_bucket edge rows (and in map mode P_pad) must
        # divide over the edge axis; power-of-two buckets with a raised
        # floor do for any power-of-two axis (global_opt.py:791-797)
        D = self._mesh_D
        E_bucket = _next_bucket(n, max(4, D // 2))
        P_pad = _next_bucket(P, 2 if D == 1 or self.shard_mode != "map"
                             else D)
        remap = {int(k): c for c, k in enumerate(unique)}
        ii_c = np.array([remap[int(k)] for k in self.ii[:n]], np.int64)
        jj_c = np.array([remap[int(k)] for k in self.jj[:n]], np.int64)
        # two-way padded endpoints; the padded rows have zero weight
        ii2 = np.zeros((2 * E_bucket,), np.int64)
        jj2 = np.zeros((2 * E_bucket,), np.int64)
        ev = np.zeros((2 * E_bucket,), bool)
        ii2[:n], jj2[:n], ev[:n] = ii_c, jj_c, True
        ii2[E_bucket:E_bucket + n] = jj_c
        jj2[E_bucket:E_bucket + n] = ii_c
        ev[E_bucket:E_bucket + n] = True
        unique_pad = np.zeros((P_pad,), np.int64)
        unique_pad[:P] = unique
        h, w = arena.img_hw
        dev = self.dev

        def put(a):
            return torch.from_numpy(a).to(dev)

        calib = residual_type == "calib"
        if self._mesh_D > 1:
            Twc_new, iters, delta, ok = _prep_and_solve_sharded(
                arena.X, arena.C, arena.N, arena.T_WC, *self._stores(),
                put(unique_pad), put(ii2), put(jj2), put(ev), self._K(),
                self.mesh, self.shard_mode, E_bucket, residual_type, (w, h),
                self.cfg, calib)
        elif self.cache_pre:
            self._sync_cache(arena, unique, calib)
            Twc_new, iters, delta, ok = _prep_and_solve_cached(
                arena.X, arena.T_WC, *self._pres(), put(unique_pad),
                put(ii2), put(jj2), self._K(), E_bucket, residual_type,
                (w, h), self.cfg, calib)
        else:
            Twc_new, iters, delta, ok = _prep_and_solve(
                arena.X, arena.C, arena.N, arena.T_WC, *self._stores(),
                put(unique_pad), put(ii2), put(jj2), put(ev), self._K(),
                E_bucket, residual_type, (w, h), self.cfg, calib)
        # the caller writes the non-pinned unique poses back; the pinned
        # and padded rows carry a slot outside any arena and are dropped
        upd = np.full((P_pad,), 1 << 30, np.int64)
        upd[pin:P] = unique[pin:]
        return upd, Twc_new, (int(iters), float(delta), bool(ok))

    def _solve(self, arena: KeyframeArena, residual_type: str):
        res = self.solve_poses(arena, residual_type)
        if res is None:
            return arena, None
        upd, Twc_new, stats = res
        return arena_update_poses(arena, Twc_new.to(arena.T_WC.device),
                                  upd), stats

    def solve_GN_rays(self, arena: KeyframeArena):
        """(global_opt.py:865)"""
        return self._solve(arena, "ray")

    def solve_GN_calib(self, arena: KeyframeArena):
        """(global_opt.py:869)"""
        return self._solve(arena, "calib")
