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
    case is a ``where`` on frame.N, as in JAX."""
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
    n_size: int = 0

    @property
    def buffer(self):
        return self.frame_id.shape[0]


def make_arena(buffer: int, h: int, w: int, n_patches: int, feat_dim: int,
               device=None) -> KeyframeArena:
    """(frame.py:210)"""
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
    )


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
