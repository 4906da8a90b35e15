"""Frame state, pointmap fusion and the keyframe arena.

Mirrors ``mast3r_slam_tpu/frame.py``.  JAX updates its pytrees
functionally; here ``Frame`` is a dataclass of tensors replaced field-wise
(``dataclasses.replace``), and the arena is written in place, which saves
a copy of the multi-GB store on every keyframe.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from .ops import lie_sim3 as sim3
from .utils.profiler import TRACER


class Mode(enum.Enum):
    """(frame.py:24)"""
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


class FilteringMode(enum.IntEnum):
    """Pointmap fusion modes (frame.py:31)."""
    FIRST = 0
    RECENT = 1
    BEST_SCORE = 2
    INDEP_CONF = 3
    WEIGHTED_POINTMAP = 4
    WEIGHTED_SPHERICAL = 5

    @classmethod
    def from_str(cls, s: str) -> "FilteringMode":
        return cls[s.upper()]


@dataclasses.dataclass
class Frame:
    """One frame (frame.py:53): canonical pointmap, fusion counters and the
    cached encoder features.  0-d tensors stay on the device, so fusion
    needs no host sync."""
    frame_id: torch.Tensor   # () int32
    uimg: torch.Tensor       # (h, w, 3) uint8
    T_WC: torch.Tensor       # (8,) Sim3
    X_canon: torch.Tensor    # (h*w, 3)
    C: torch.Tensor          # (h*w, 1)
    feat: torch.Tensor       # (n_patches, enc_dim) f32
    pos: torch.Tensor        # (n_patches, 2) int
    N: torch.Tensor          # () int32 fusion count
    N_updates: torch.Tensor  # () int32
    score: torch.Tensor      # () f32 (best_score mode)

    @property
    def hw(self):
        return self.uimg.shape[0] * self.uimg.shape[1]

    def get_average_conf(self):
        """C / N (frame.py:78)."""
        return self.C / torch.clamp(self.N, min=1).to(self.C.dtype)

    def replace(self, **kw) -> "Frame":
        return dataclasses.replace(self, **kw)


def _cartesian_to_spherical(P):
    r = torch.linalg.norm(P, dim=-1, keepdim=True)
    x, y, z = P.split(1, dim=-1)
    phi = torch.atan2(y, x)
    theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-12), -1.0, 1.0))
    return torch.cat([r, phi, theta], dim=-1)


def _spherical_to_cartesian(s):
    r, phi, theta = s.split(1, dim=-1)
    return torch.cat([r * torch.sin(theta) * torch.cos(phi),
                      r * torch.sin(theta) * torch.sin(phi),
                      r * torch.cos(theta)], dim=-1)


def update_pointmap(frame: Frame, X, C, mode: FilteringMode,
                    use_median_score: bool = True) -> Frame:
    """Pointmap fusion, all six modes (frame.py:114).  The first-update
    case is a ``where`` on frame.N, as in JAX.  Span ``frame.fuse``."""
    with TRACER.span("frame.fuse"):
        return _fuse(frame, X, C, mode, use_median_score)


def _fuse(frame: Frame, X, C, mode: FilteringMode,
          use_median_score: bool) -> Frame:
    first = frame.N == 0
    one = torch.ones_like(frame.N)
    if mode == FilteringMode.FIRST:
        keep_new = first | (frame.N_updates == 1)
        X_new = torch.where(keep_new, X, frame.X_canon)
        C_new = torch.where(keep_new, C, frame.C)
        N_new = torch.where(first, one, frame.N)
        score_new = frame.score
    elif mode == FilteringMode.RECENT:
        X_new, C_new, N_new, score_new = X, C, one, frame.score
    elif mode == FilteringMode.BEST_SCORE:
        # jnp.median averages the two middle values, as quantile does
        new_score = torch.quantile(C.flatten(), 0.5) if use_median_score \
            else torch.mean(C)
        better = first | (new_score > frame.score)
        X_new = torch.where(better, X, frame.X_canon)
        C_new = torch.where(better, C, frame.C)
        N_new = one
        score_new = torch.where(better, new_score, frame.score)
    elif mode == FilteringMode.INDEP_CONF:
        better = first | (C > frame.C)
        X_new = torch.where(better, X, frame.X_canon)
        C_new = torch.where(better, C, frame.C)
        N_new, score_new = one, frame.score
    elif mode == FilteringMode.WEIGHTED_POINTMAP:
        denom = torch.clamp(frame.C + C, min=1e-12)
        X_fused = (frame.C * frame.X_canon + C * X) / denom
        X_new = torch.where(first, X, X_fused)
        C_new = torch.where(first, C, frame.C + C)
        N_new = torch.where(first, one, frame.N + 1)
        score_new = frame.score
    elif mode == FilteringMode.WEIGHTED_SPHERICAL:
        s_old = _cartesian_to_spherical(frame.X_canon)
        s_new = _cartesian_to_spherical(X)
        denom = torch.clamp(frame.C + C, min=1e-12)
        fused = _spherical_to_cartesian((frame.C * s_old + C * s_new) / denom)
        X_new = torch.where(first, X, fused)
        C_new = torch.where(first, C, frame.C + C)
        N_new = torch.where(first, one, frame.N + 1)
        score_new = frame.score
    else:
        raise ValueError(mode)
    return frame.replace(X_canon=X_new, C=C_new, N=N_new.to(torch.int32),
                         N_updates=frame.N_updates + 1, score=score_new)


@dataclasses.dataclass
class KeyframeArena:
    """Fixed-capacity keyframe store (frame.py:177), fields stacked along a
    leading [buffer] axis.  ``n_size`` is a host int: the frontend reads it
    every frame, and a device scalar would cost a sync each time."""
    frame_id: torch.Tensor   # (B,) int32
    uimg: torch.Tensor       # (B, h, w, 3) uint8
    T_WC: torch.Tensor       # (B, 8)
    X: torch.Tensor          # (B, h*w, 3)
    C: torch.Tensor          # (B, h*w, 1)
    N: torch.Tensor          # (B,) int32
    N_updates: torch.Tensor  # (B,) int32
    feat: torch.Tensor       # (B, n_patches, feat_dim)
    pos: torch.Tensor        # (B, n_patches, 2)
    K: torch.Tensor          # (3, 3) intrinsics, zeros when uncalibrated
    n_size: int = 0

    @property
    def buffer(self):
        return self.frame_id.shape[0]

    @property
    def img_hw(self):
        return self.uimg.shape[1], self.uimg.shape[2]


def make_arena(buffer: int, h: int, w: int, n_patches: int, feat_dim: int,
               device=None, K=None) -> KeyframeArena:
    """(frame.py:210)  ``K`` (3, 3): a copy goes into the arena's ``K``
    field, zeros when None (pipeline.py:96)."""
    kw = dict(device=device)
    return KeyframeArena(
        frame_id=torch.zeros((buffer,), dtype=torch.int32, **kw),
        uimg=torch.zeros((buffer, h, w, 3), dtype=torch.uint8, **kw),
        T_WC=sim3.identity((buffer,), device=device),
        X=torch.zeros((buffer, h * w, 3), **kw),
        C=torch.zeros((buffer, h * w, 1), **kw),
        N=torch.zeros((buffer,), dtype=torch.int32, **kw),
        N_updates=torch.zeros((buffer,), dtype=torch.int32, **kw),
        feat=torch.zeros((buffer, n_patches, feat_dim), **kw),
        pos=torch.zeros((buffer, n_patches, 2), dtype=torch.int64, **kw),
        K=torch.zeros((3, 3), **kw) if K is None else
        torch.as_tensor(K, dtype=torch.float32).to(device).clone(),
    )


def arena_grow(arena: KeyframeArena, new_buffer: int) -> KeyframeArena:
    """A copy of the arena with ``new_buffer`` slots, the new ones zero
    with identity poses, ``K`` carried (frame.py:227).  The pipeline grows
    the store by power-of-two buckets before an append would pass its
    capacity."""
    if new_buffer < arena.buffer:
        raise ValueError(f"arena_grow: {new_buffer} < {arena.buffer}")
    pad = new_buffer - arena.buffer

    def grow(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

    return dataclasses.replace(
        arena,
        frame_id=grow(arena.frame_id), uimg=grow(arena.uimg),
        T_WC=torch.cat([arena.T_WC,
                        sim3.identity((pad,), device=arena.T_WC.device)]),
        X=grow(arena.X), C=grow(arena.C), N=grow(arena.N),
        N_updates=grow(arena.N_updates), feat=grow(arena.feat),
        pos=grow(arena.pos))


def arena_set(arena: KeyframeArena, idx: int, frame: Frame) -> KeyframeArena:
    """Write a frame into slot idx, in place (frame.py:261).  Raises past
    capacity, where a scatter would drop the row."""
    if not 0 <= idx < arena.buffer:
        raise IndexError(f"keyframe slot {idx} outside arena of "
                         f"{arena.buffer}")
    arena.frame_id[idx] = frame.frame_id
    arena.uimg[idx] = frame.uimg
    arena.T_WC[idx] = frame.T_WC
    arena.X[idx] = frame.X_canon
    arena.C[idx] = frame.C
    arena.N[idx] = frame.N
    arena.N_updates[idx] = frame.N_updates
    arena.feat[idx] = frame.feat
    arena.pos[idx] = frame.pos
    arena.n_size = max(arena.n_size, idx + 1)
    return arena


def arena_append(arena: KeyframeArena, frame: Frame) -> KeyframeArena:
    """(frame.py:278)"""
    return arena_set(arena, arena.n_size, frame)


def arena_get(arena: KeyframeArena, idx: int) -> Frame:
    """Read slot idx as a Frame; the tensors are copies, so the caller may
    fuse into them freely (frame.py:282)."""
    return Frame(
        frame_id=arena.frame_id[idx].clone(),
        uimg=arena.uimg[idx].clone(),
        T_WC=arena.T_WC[idx].clone(),
        X_canon=arena.X[idx].clone(),
        C=arena.C[idx].clone(),
        feat=arena.feat[idx].clone(),
        pos=arena.pos[idx].clone(),
        N=arena.N[idx].clone(),
        N_updates=arena.N_updates[idx].clone(),
        score=torch.zeros((), device=arena.X.device),
    )


def arena_pop_last(arena: KeyframeArena) -> KeyframeArena:
    """Drop the last keyframe (frame.py:299); its slot is reused by the
    next append."""
    arena.n_size = max(arena.n_size - 1, 0)
    return arena


def arena_snapshot(arena: KeyframeArena) -> KeyframeArena:
    """A view of the arena that later in-place writes do not change: the
    rows a backend round reads while the frontend goes on writing
    (pipeline.py:236).  Rows below ``n_size - 1`` change only in
    ``T_WC`` once a newer keyframe exists, but the frontend fuses into row
    ``n_size - 1`` every frame and a tensor cannot lend some rows and own
    others, so ``X`` and ``C`` are copied up to ``n_size``, and ``T_WC``,
    ``N`` and ``N_updates`` whole (B rows of a few bytes).  ``frame_id``,
    ``uimg``, ``feat``, ``pos`` and ``K`` are the live tensors: the
    frontend writes their rows below ``n_size`` only with the values they
    hold, and ``arena_grow`` replaces the live arena's tensors, not
    these."""
    n = arena.n_size
    return dataclasses.replace(
        arena, T_WC=arena.T_WC.clone(), X=arena.X[:n].clone(),
        C=arena.C[:n].clone(), N=arena.N.clone(),
        N_updates=arena.N_updates.clone())


def arena_update_poses(arena: KeyframeArena, T_WCs, idx) -> KeyframeArena:
    """Write optimised poses T_WCs (n, 8) into the slots ``idx`` (n,), a
    host array (frame.py:303).  A slot outside the arena is dropped, as
    JAX's scatter drops it: the backend marks pinned and padded rows so
    (``global_opt.FactorGraph.solve_poses``).  The mask is taken on the
    host, so the write costs no sync."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device="cpu")
    rows = torch.nonzero((idx >= 0) & (idx < arena.buffer))[:, 0]
    dev = arena.T_WC.device
    arena.T_WC[idx[rows].to(dev)] = T_WCs.index_select(0, rows.to(dev)) \
        .to(arena.T_WC.dtype)
    return arena


# the per-keyframe fields of the arena (K is one matrix, n_size a host int)
ARENA_ROW_FIELDS = ("frame_id", "uimg", "T_WC", "X", "C", "N", "N_updates",
                    "feat", "pos")


def arena_copy(arena: KeyframeArena, device) -> KeyframeArena:
    """A copy of the whole arena on ``device``, with storage of its own also
    on the arena's own device: the backend's mirror arena
    (pipeline.py:181-184), which later in-place writes to the live arena
    must not reach."""
    return dataclasses.replace(arena, **{
        name: getattr(arena, name).to(device, copy=True)
        for name in ARENA_ROW_FIELDS + ("K",)})


def arena_copy_rows(dst: KeyframeArena, src: KeyframeArena, rows) -> int:
    """Copy the keyframe rows ``rows`` (host ints) of every per-keyframe
    field from ``src`` into ``dst``, which may lie on another device
    (``_mirror_set`` of pipeline.py:284-287).  Returns the count."""
    rows = sorted(int(r) for r in rows)
    if not rows:
        return 0
    idx = torch.tensor(rows, dtype=torch.int64)
    for name in ARENA_ROW_FIELDS:
        s, d = getattr(src, name), getattr(dst, name)
        d[idx.to(d.device)] = s[idx.to(s.device)].to(d.device)
    return len(rows)
