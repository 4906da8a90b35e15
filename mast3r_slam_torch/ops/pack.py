"""Probe-table packing for the dense matcher: the CUDA kernel and its plain
versions.

Counterpart of ``mast3r_slam_tpu/ops/pack.py``: ``pack_rows`` replaces the
Pallas ``_mxu_pack_kernel`` (pack.py:73, ``pack_rows_mxu``) with
``csrc/pack.cu``.  Row ``r`` of a packed table holds the table rows at a
fixed set of flat offsets around ``r + row0`` side by side, so the matcher
fetches the four bilinear corners of the LM ray table, or several probe
columns of a descriptor window, with one row gather
(``ops/matching.py::iter_proj``, ``refine_matches``).

Rows outside ``[0, hw)`` read as zeros, as in ``pack_rows_mxu`` (the
``jnp.pad`` of pack.py:133).  ``row0`` and ``n_rows`` let the matcher build
the rows ``[-rd, hw + rd)`` it gathers without a modular wrap, so that every
probe inside the image reads its own descriptor for border queries too (see
``refine_matches``).
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import functools
import math

import torch

from .. import _build

MAX_K = 64          # PACK_MAX_K of csrc/pack.cu
_DTYPES = (torch.int8, torch.float16, torch.bfloat16, torch.float32)
# the kernel's tiling: output bytes a tile aims at, the staging a block aims
# at, and the most a block may stage (PACK_MAX_SMEM of csrc/pack.cu)
_TILE_OUT_BYTES = 16384
_TILE_SMEM_BYTES = 24576
_MAX_SMEM_BYTES = 227 * 1024 - 1024


def _offsets(k_side: int, d: int, rd: int, w: int, u_count: int):
    """Flat row offsets in the matcher's packed-block order: u-pack p
    outer, v-offset j inner; block (p, j) reads row m + p*d + (j*d - rd)*w
    (pack.py:47)."""
    return [p * d + (j * d - rd) * w
            for p in range(u_count) for j in range(k_side)]


def _rows(flat, row0, n_rows):
    if flat.dim() != 3:
        raise ValueError(f"pack_rows: flat must be (b, hw, F), got "
                         f"{tuple(flat.shape)}")
    n_rows = flat.shape[1] if n_rows is None else int(n_rows)
    if n_rows < 0:
        raise ValueError(f"pack_rows: n_rows={n_rows}")
    return int(row0), n_rows


def pack_rows_plain(flat, offsets, row0: int = 0, n_rows: int | None = None):
    """``out[b, r, k*F + c] = flat[b, r + row0 + offsets[k], c]`` where that
    row is in ``[0, hw)``, else 0: the kernel's plain version and the CPU
    path.  K slice copies into a zeroed table."""
    row0, n_rows = _rows(flat, row0, n_rows)
    b, hw, F = flat.shape
    K = len(offsets)
    out = flat.new_zeros((b, n_rows, K, F))
    for k, off in enumerate(offsets):
        lo = row0 + int(off)              # source row of output row 0
        a, e = max(lo, 0), min(lo + n_rows, hw)
        if e > a:
            out[:, a - lo:e - lo, k] = flat[:, a:e]
    return out.reshape(b, n_rows, K * F)


def pack_rows_roll(flat, offsets):
    """The wrap build: out row m, block k = flat[(m + offsets[k]) mod hw]
    (pack.py:141).  Differs from ``pack_rows_plain`` only in rows whose
    source falls outside ``[0, hw)``; kept for the tests."""
    return torch.cat([torch.roll(flat, -int(s), dims=1) for s in offsets],
                     dim=-1)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tiling of ``csrc/pack.cu``: a block packs ``rows`` consecutive
    output rows for one group of consecutive offsets; group g covers offsets
    ``[group_k[g], group_k[g+1])`` and stages spans ``[group_span[g],
    group_span[g+1])``.  Span s is the source rows ``r0 + row0 +
    span_lo[s] + [0, span_rows[s])`` of a tile starting at output row r0,
    staged at byte ``span_smem[s]``; offset k reads span ``k_span[k]`` from
    row ``k_delta[k]`` on.  ``smem`` is the staging a block takes;
    ``c_args`` the plan as ``csrc/pack.cu::pack_rows`` takes it, its ctypes
    arrays built once."""
    rows: int
    group_k: tuple
    group_span: tuple
    span_lo: tuple
    span_rows: tuple
    span_smem: tuple
    k_span: tuple
    k_delta: tuple
    smem: int
    c_args: tuple = dataclasses.field(compare=False, repr=False)


def _round16(n):
    return -(-n // 16) * 16


def _spans(offsets, ks, rows):
    """[lo, hi] of each span of the offsets ``ks``: sorted offsets whose
    ``rows``-row windows overlap the span's first share one load."""
    spans = []
    for off in sorted({offsets[k] for k in ks}):
        if spans and off - spans[-1][0] < rows:
            spans[-1][1] = off
        else:
            spans.append([off, off])
    return spans


def _staging(spans, rows, row_bytes):
    """Bytes a block stages: each span's 16-byte aligned cover."""
    return sum(_round16((rows + hi - lo) * row_bytes) + 16 for lo, hi in spans)


@functools.lru_cache(maxsize=256)
def tile_plan(offsets: tuple, row_bytes: int, n_rows: int) -> TilePlan:
    """The kernel's tiling for K = len(offsets) offsets of ``row_bytes``-byte
    rows.  The tile is the most rows (a multiple of the count that makes its
    output a multiple of 16 bytes, up to ``_TILE_OUT_BYTES`` of output)
    whose spans fit ``_TILE_SMEM_BYTES``; when not even one output row fits,
    R is 1 and the offsets are cut into consecutive groups that do (a group
    may take up to ``_MAX_SMEM_BYTES``)."""
    K = len(offsets)
    out_row = K * row_bytes
    step = 16 // math.gcd(out_row, 16)
    top = max(step, _TILE_OUT_BYTES // out_row // step * step)
    top = min(top, -(-max(n_rows, 1) // step) * step)
    groups = None
    for rows in [*range(top, 0, -step), 1]:
        spans = _spans(offsets, range(K), rows)
        if _staging(spans, rows, row_bytes) <= _TILE_SMEM_BYTES:
            groups = [(0, K, spans)]
            break
    if groups is None:
        rows, groups, k0 = 1, [], 0
        while k0 < K:
            k1 = k0 + 1
            while k1 < K and _staging(_spans(offsets, range(k0, k1 + 1), 1),
                                      1, row_bytes) <= _TILE_SMEM_BYTES:
                k1 += 1
            spans = _spans(offsets, range(k0, k1), 1)
            if _staging(spans, 1, row_bytes) > _MAX_SMEM_BYTES:
                raise ValueError(f"pack_rows kernel: a {row_bytes}-byte row "
                                 f"does not fit in shared memory")
            groups.append((k0, k1, spans))
            k0 = k1
    group_k, group_span = [0], [0]
    span_lo, span_rows, span_smem = [], [], []
    k_span, k_delta = [0] * K, [0] * K
    smem = 16
    for k0, k1, spans in groups:
        first, at = len(span_lo), 0
        for lo, hi in spans:
            span_lo.append(lo)
            span_rows.append(rows + hi - lo)
            span_smem.append(at)
            at += _round16((rows + hi - lo) * row_bytes) + 16
        smem = max(smem, at)
        los = [lo for lo, _ in spans]
        for k in range(k0, k1):
            s = bisect.bisect_right(los, offsets[k]) - 1
            k_span[k], k_delta[k] = first + s, offsets[k] - los[s]
        group_k.append(k1)
        group_span.append(len(span_lo))

    def arr(ctype, values):
        return (ctype * len(values))(*values)

    i32 = ctypes.c_int
    c_args = (rows, len(group_k) - 1, arr(i32, group_k), arr(i32, group_span),
              len(span_lo), arr(ctypes.c_longlong, span_lo),
              arr(i32, span_rows), arr(i32, span_smem), arr(i32, k_span),
              arr(i32, k_delta), smem)
    return TilePlan(rows, tuple(group_k), tuple(group_span), tuple(span_lo),
                    tuple(span_rows), tuple(span_smem), tuple(k_span),
                    tuple(k_delta), smem, c_args)


@functools.lru_cache(maxsize=None)
def _kernel():
    """``pack_rows`` of the built library, its C signature declared."""
    fn = _build.load("pack").pack_rows
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    p32 = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, i32, i32, i32, p32, p32,
                   i32, ctypes.POINTER(i64), p32, p32, p32, p32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def pack_rows(flat, offsets, row0: int = 0, n_rows: int | None = None):
    """The packed table (b, n_rows, K*F) of ``flat`` (b, hw, F) for the K
    integer ``offsets`` (any sign).  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/pack.cu`` or raise."""
    if flat.device.type == "cpu":
        return pack_rows_plain(flat, offsets, row0, n_rows)
    if flat.device.type != "cuda":
        raise ValueError(f"pack_rows: unsupported device {flat.device}")
    row0, n_rows = _rows(flat, row0, n_rows)
    b, _, F = flat.shape
    out = torch.empty((b, n_rows, len(offsets) * F), dtype=flat.dtype,
                      device=flat.device)
    return pack_rows_into(out, flat, offsets, row0)


def pack_rows_into(out, flat, offsets, row0: int = 0):
    """``pack_rows`` written into ``out`` (b, n_rows, K*F), a contiguous CUDA
    tensor of ``flat``'s dtype at any byte alignment (a slice of a larger
    buffer, say).  Launches ``csrc/pack.cu``; returns ``out``."""
    row0, _ = _rows(flat, row0, None)
    offsets = tuple(int(s) for s in offsets)
    K = len(offsets)
    if flat.device.type != "cuda" or out.device != flat.device:
        raise ValueError("pack_rows kernel takes CUDA tensors on one device")
    if flat.dtype not in _DTYPES or not flat.is_contiguous():
        raise ValueError("pack_rows kernel takes a contiguous int8, f16, "
                         "bf16 or f32 table")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"pack_rows kernel takes 1..{MAX_K} offsets, got {K}")
    b, hw, F = flat.shape
    if b < 1 or hw < 1 or F < 1 or b > 65535:
        raise ValueError(f"pack_rows: empty or oversized table "
                         f"{tuple(flat.shape)}")
    if out.dtype != flat.dtype or not out.is_contiguous() or \
            out.dim() != 3 or out.shape[0] != b or out.shape[2] != K * F:
        raise ValueError(f"pack_rows: output {tuple(out.shape)} {out.dtype} "
                         f"is not a contiguous ({b}, n_rows, {K * F}) "
                         f"{flat.dtype} tensor")
    n_rows = out.shape[1]
    row_bytes = F * flat.element_size()
    plan = tile_plan(offsets, row_bytes, n_rows)
    with torch.cuda.device(flat.device):
        err = _kernel()(
            flat.data_ptr(), out.data_ptr(), b, hw, row_bytes, n_rows, row0,
            K, *plan.c_args,
            torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(err, "pack_rows")
    _build.count_launch(pack_rows)
    return out


pack_rows.launches = 0
