"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one. The file imports nothing of JAX, because the card's machine has none;
run it there, without the JAX test configuration, with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

Tolerances: bf16 attention 2e-2 and f32 attention 1e-4 max abs error on
N(0,1) inputs (the kernel's f32 FMA order differs from the plain version's
matrix products); each of the 27 GN sums, at a pose far from the identity,
within 1e-4 of itself plus 1e-5 of the sum of its terms' magnitudes (a
block reduction in another order than torch's sum; ``testing.gn_sums_check``),
and bitwise equality between two launches (a fixed fold order).
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import testing
from mast3r_slam_torch.ops import attention as tattn
from mast3r_slam_torch.ops import gn as tgn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(1, 16, 768, 768, 64),
                                   (1, 12, 768, 768, 64),
                                   (2, 3, 300, 300, 64),
                                   (1, 12, 768, 512, 64)])
def test_attention_kernel_matches_plain(cuda, shape, dtype, tol):
    B, H, Nq, Nk, Dh = shape
    rng = np.random.default_rng(Nq + Nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n, Dh))
                                .astype(np.float32)).to(cuda, dtype)
               for n in (Nq, Nk, Nk))
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - tattn.attention_plain(q, k, v).float()).abs().max()
    assert float(err) <= tol


@pytest.mark.cuda
def test_attention_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        tattn.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [196608, 1000])
def test_gn_kernel_matches_plain_and_is_deterministic(cuda, n):
    pre, T = testing.gn_problem(n, n, cuda)
    scal = tgn.rot_scalars(T)
    before = tgn.gn_sums.launches
    a1 = tgn.gn_sums(pre.pts, scal, 1.345)
    a2 = tgn.gn_sums(pre.pts, scal, 1.345)
    torch.cuda.synchronize()
    assert tgn.gn_sums.launches == before + 2
    assert torch.equal(a1, a2)
    err, tol = testing.gn_sums_check(
        a1, tgn.gn_terms_plain(pre.pts, scal, 1.345))
    assert bool((err <= tol).all()), (err / tol).tolist()
