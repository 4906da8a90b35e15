"""Exact attention for the MASt3R blocks: the CUDA kernel and its plain
version.

Mirrors ``mast3r_slam_tpu/ops/attention.py``: ``flash_attention`` replaces
the Pallas ``_attn_kernel`` (attention.py:28) with ``csrc/attention.cu``
(bf16 on the tensor cores, f32 on plain FMA).  Layout is the JAX package's:
q (B, H, Nq, Dh), k and v (B, H, Nk, Dh), output (B, H, Nq, Dh) in q's
dtype, softmax in f32.  The kernel reads q, k and v through their strides,
so the ``(B, N, H, Dh)``-strided views the model holds need no copy, and it
writes the output as such a view: ``out.transpose(1, 2)`` is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_DH = (64,)


def attention_plain(q, k, v):
    """softmax((q k^T) * scale, f32) v, cast to q's dtype: the kernel's
    plain version and the CPU path (attention.py:28-43).  Not SDPA."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _lib():
    lib = _build.load("attention")
    fn = lib.attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, N, Dh) tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes bf16 or f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, _, Dh = q.shape
    if Dh not in _KERNEL_DH:
        raise ValueError(f"flash_attention kernel is built for Dh in "
                         f"{_KERNEL_DH}, got {Dh}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != H \
            or k.shape[3] != Dh:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    # the kernel copies rows of Dh in 16-byte pieces
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel needs a contiguous "
                             f"last dimension, {name} has strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16 or any(
                t.stride(d) % per16 for d in range(3) if t.shape[d] > 1):
            raise ValueError(f"flash_attention kernel needs 16-byte aligned "
                             f"rows, {name} has strides {t.stride()}")


def flash_attention(q, k, v):
    """Exact fused attention (attention.py:47).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/attention.cu`` or raise.  q, k and v
    may be strided views with a contiguous last dimension; the kernel's
    output is a (B, H, Nq, Dh) view of (B, Nq, H, Dh) memory."""
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"q, k, v on different devices: {devs}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_kernel_inputs(q, k, v)
    B, H, Nq, Dh = q.shape
    Nk = k.shape[2]
    out = torch.empty((B, Nq, H, Dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(d) for t in (q, k, v, out) for d in range(3)))
    err = _lib().attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Nq, Nk, Dh, _DTYPES[q.dtype], strides, 1.0 / (Dh ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
