"""Attention: the port's plain version against the JAX Pallas kernel (run in
interpret mode, as the JAX tests run it) and against XLA's attention, f32,
self and cross shapes, atol 1e-5; strided (B, N, H, Dh) views, as the model
hands them over, against the contiguous call bit for bit.  The CUDA kernel
itself is held against the plain version on the card in
``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.attention import flash_attention as jax_flash
from mast3r_slam_torch.ops import attention as tattn

SHAPES = [  # (B, H, Nq, Nk, Dh)
    (2, 3, 40, 40, 64),     # self
    (1, 2, 24, 56, 32),     # cross, Nq != Nk
    (1, 4, 37, 37, 16),     # ragged N
]


def _inputs(shape, seed):
    B, H, Nq, Nk, Dh = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Nk, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Nk, Dh)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    q, k, v = _inputs(shape, 0)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    interpret=True)
    out = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_attention(shape):
    q, k, v = _inputs(shape, 1)
    ref = jax.nn.dot_product_attention(
        jnp.asarray(q).swapaxes(1, 2), jnp.asarray(k).swapaxes(1, 2),
        jnp.asarray(v).swapaxes(1, 2)).swapaxes(1, 2)
    out = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    kernel launch."""
    q, k, v = map(torch.from_numpy, _inputs(SHAPES[0], 2))
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v)
    assert tattn.flash_attention.launches == before
    assert torch.equal(out, tattn.attention_plain(q, k, v))


def test_plain_keeps_bf16_dtype():
    q, k, v = (t.to(torch.bfloat16)
               for t in map(torch.from_numpy, _inputs(SHAPES[1], 3)))
    assert tattn.attention_plain(q, k, v).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", SHAPES)
def test_strided_views_equal_the_contiguous_call(shape):
    """q, k and v as (B, H, N, Dh) views of (B, N, H, Dh) memory, and as
    views of one packed (B, N, 3, H, Dh) product, give the bits of the
    contiguous call."""
    q, k, v = map(torch.from_numpy, _inputs(shape, 4))
    ref = tattn.flash_attention(q, k, v)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not any(t.is_contiguous() for t in views if t.shape[2] > 1)
    assert torch.equal(tattn.flash_attention(*views), ref)
    if q.shape == k.shape:
        qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
        packed = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        assert torch.equal(tattn.flash_attention(*packed), ref)
