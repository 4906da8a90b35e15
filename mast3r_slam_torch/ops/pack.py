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

import ctypes

import torch

from .. import _build

MAX_K = 64          # PACK_MAX_K of csrc/pack.cu
_DTYPES = (torch.int8, torch.float16, torch.bfloat16, torch.float32)


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


def _lib():
    lib = _build.load("pack")
    fn = lib.pack_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def pack_rows(flat, offsets, row0: int = 0, n_rows: int | None = None):
    """The packed table (b, n_rows, K*F) of ``flat`` (b, hw, F) for the K
    integer ``offsets`` (any sign).  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/pack.cu`` or raise."""
    if flat.device.type == "cpu":
        return pack_rows_plain(flat, offsets, row0, n_rows)
    if flat.device.type != "cuda":
        raise ValueError(f"pack_rows: unsupported device {flat.device}")
    row0, n_rows = _rows(flat, row0, n_rows)
    K = len(offsets)
    if flat.dtype not in _DTYPES or not flat.is_contiguous():
        raise ValueError("pack_rows kernel takes a contiguous int8, f16, "
                         "bf16 or f32 table")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"pack_rows kernel takes 1..{MAX_K} offsets, got {K}")
    b, hw, F = flat.shape
    if b < 1 or hw < 1 or F < 1 or b > 65535:
        raise ValueError(f"pack_rows: empty or oversized table "
                         f"{tuple(flat.shape)}")
    out = torch.empty((b, n_rows, K * F), dtype=flat.dtype,
                      device=flat.device)
    offs = (ctypes.c_longlong * K)(*(int(s) for s in offsets))
    with torch.cuda.device(flat.device):
        err = _lib().pack_rows(
            flat.data_ptr(), out.data_ptr(), b, hw, F * flat.element_size(),
            n_rows, row0, K, offs,
            torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(err, "pack_rows")
    pack_rows.launches += 1
    return out


pack_rows.launches = 0
