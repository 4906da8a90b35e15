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
and bitwise equality between two launches (a fixed fold order).  The pack
kernel is a copy: bitwise equal to its plain version, no tolerance.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import testing
from mast3r_slam_torch.ops import attention as tattn
from mast3r_slam_torch.ops import gn as tgn
from mast3r_slam_torch.ops import pack as tpack


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.float16, torch.bfloat16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("b,h,w,f,k_side,d,u_pack", [
    (1, 384, 512, 24, 7, 4, 2),   # production refine, 16-byte units
    (1, 384, 512, 9, 0, 0, 0),    # LM corner table: 18-byte f16 rows
    (2, 300, 7, 12, 5, 2, 5),     # nibble-table width, a grid no tile divides
    (1, 40, 33, 5, 3, 1, 3),      # odd row width: byte units for int8
])
def test_pack_kernel_matches_plain_bitwise(cuda, dtype, b, h, w, f, k_side, d,
                                           u_pack):
    hw = h * w
    rng = np.random.default_rng(hw + f)
    flat = torch.from_numpy(rng.integers(-127, 128, (b, hw, f))).to(cuda, dtype)
    if k_side:
        rd = (k_side // 2) * d
        offs = tpack._offsets(k_side, d, rd, w, u_pack)
        row0, n_rows = -rd, hw + 2 * rd
    else:
        offs, row0, n_rows = (0, 1, w, w + 1), 0, None
    before = tpack.pack_rows.launches
    got = tpack.pack_rows(flat, offs, row0, n_rows)
    torch.cuda.synchronize()
    assert tpack.pack_rows.launches == before + 1
    ref = tpack.pack_rows_plain(flat, offs, row0, n_rows)
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.cuda
def test_pack_kernel_refuses_a_strided_table(cuda):
    flat = torch.zeros(1, 24, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tpack.pack_rows(flat.transpose(1, 2), (0, 1))
