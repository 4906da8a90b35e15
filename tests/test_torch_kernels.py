"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one. The file imports nothing of JAX, because the card's machine has none;
run it there, without the JAX test configuration, with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

Tolerances: bf16 attention 2e-2 and f32 attention 1e-4 max abs error on
N(0,1) inputs (the bf16 kernel rounds P to bf16 before its second
tensor-core product, the f32 kernel's FMA order differs from the plain
version's matrix products); the pose of the whole-solve kernel within 1e-5
of the plain host loop, with equal ``ok`` and iteration count; each of the
27 GN sums, at a pose far from the identity,
within 1e-4 of itself plus 1e-5 of the sum of its terms' magnitudes (a
block reduction in another order than torch's sum; ``testing.gn_sums_check``),
and bitwise equality between two launches (a fixed fold order).  The pack
kernel is a copy: bitwise equal to its plain version, no tolerance, on
every production table in the four dtypes, at odd byte offsets and on the
tilings' edge cases.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import testing
from mast3r_slam_torch.ops import attention as tattn
from mast3r_slam_torch.ops import gn as tgn
from mast3r_slam_torch.ops import lie_sim3 as tsim3
from mast3r_slam_torch.ops import pack as tpack
from mast3r_slam_torch.tracker import TrackerConfig


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
@pytest.mark.parametrize("nk", [1, 77, 768, 769])
@pytest.mark.parametrize("nq", [1, 77, 768, 769])
def test_attention_kernel_ragged_sizes_on_strided_views(cuda, nq, nk):
    """bf16 on (B, H, N, Dh) views of (B, N, H, Dh) memory, sizes that no
    tile divides, and a V whose columns carry distinct offsets, so that a
    wrong lane in the P fragment or in V's descriptor moves a column."""
    B, H, Dh = 2, 3, 64
    rng = np.random.default_rng(1000 * nq + nk)

    def view(n, offset=0.0, scale=1.0):
        x = rng.standard_normal((B, n, H, Dh)).astype(np.float32)
        return torch.from_numpy(scale * x + offset).to(
            cuda, torch.bfloat16).transpose(1, 2)

    code = ((np.arange(Dh) * 37) % Dh / (Dh / 2) - 1.0).astype(np.float32)
    q, k, v = view(nq), view(nk), view(nk, code, 0.1)
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    err = (out.float() - tattn.attention_plain(q, k, v).float()).abs().max()
    assert float(err) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_attention_kernel_takes_views_of_a_packed_qkv(cuda, dtype, tol):
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((1, 300, 3, 4, 64))
                           .astype(np.float32)).to(cuda, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = tattn.flash_attention(q, k, v)
    ref = tattn.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    err = (out.float() - tattn.attention_plain(q, k, v).float()).abs().max()
    assert float(err) <= tol


@pytest.mark.cuda
def test_attention_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        tattn.flash_attention(q, q, q)


@pytest.mark.cuda
def test_attention_kernel_rejects_a_strided_last_dimension(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    bad = torch.zeros(1, 2, 64, 8, device=cuda,
                      dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tattn.flash_attention(q, bad, q)
    odd = torch.zeros(1, 2, 8, 68, device=cuda,
                      dtype=torch.bfloat16)[..., 4:]   # rows off 16 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.flash_attention(q, q, odd)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["near", "identity", "singular"])
@pytest.mark.parametrize("n", [196608, 1000])
def test_gn_solve_kernel_matches_plain_loop(cuda, n, start):
    """The whole solve in one launch against the host loop over the plain
    sums on the same tensors: from a pose near the solution, from the
    identity (several iterations) and with all weights zero (``ok`` False,
    T unchanged, one iteration)."""
    cfg = TrackerConfig()
    pre, T = testing.gn_problem(n, n, cuda)
    if start == "identity":
        T = tsim3.identity(device=cuda)
    elif start == "singular":
        pre.pts[7:] = 0.0
    before = tgn.gn_solve.launches
    T1, ok1, it1 = tgn.gn_solve(pre, T, cfg)
    T2, ok2, it2 = tgn.gn_solve(pre, T, cfg)
    assert tgn.gn_solve.launches == before + 2
    assert torch.equal(T1, T2) and (ok1, it1) == (ok2, it2)
    Tp, okp, itp = tgn.gn_solve_plain(pre, T, cfg)
    assert ok1 == okp == (start != "singular") and it1 == itp
    assert float((T1 - Tp).abs().max()) <= 1e-5
    if start == "singular":
        assert torch.equal(T1, T) and it1 == 1
    elif start == "identity":
        assert it1 > 2


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


# the four tables one production match packs at 384x512 (config/base.yaml):
# (F, offsets, row0, n_rows)
_W, _HW = 512, 384 * 512
PRODUCTION_TABLES = {
    "lm corners": (9, (0, 1, _W, _W + 1), 0, _HW),
    "refine d=4": (24, tuple(tpack._offsets(7, 4, 12, _W, 2)), -12, _HW + 24),
    "refine d=2": (24, tuple(tpack._offsets(5, 2, 4, _W, 5)), -4, _HW + 8),
    "refine d=1": (24, tuple(tpack._offsets(3, 1, 1, _W, 3)), -1, _HW + 2),
}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.float16, torch.bfloat16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("table", list(PRODUCTION_TABLES))
def test_pack_kernel_production_tables_bitwise(cuda, table, dtype):
    F, offs, row0, n_rows = PRODUCTION_TABLES[table]
    rng = np.random.default_rng(len(offs))
    flat = torch.from_numpy(rng.integers(-127, 128, (1, _HW, F))).to(cuda,
                                                                    dtype)
    got = tpack.pack_rows(flat, offs, row0, n_rows)
    torch.cuda.synchronize()
    assert _same_bits(got, tpack.pack_rows_plain(flat, offs, row0, n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shift", [(torch.int8, 1), (torch.int8, 7),
                                         (torch.float16, 2),
                                         (torch.float32, 4)], ids=str)
def test_pack_kernel_at_odd_byte_offsets(cuda, dtype, shift):
    """Source and output as contiguous slices of larger buffers, starting
    ``shift`` bytes past a 16-byte boundary."""
    b, hw, F = 2, 300 * 7, 9
    offs, row0, n_rows = tuple(tpack._offsets(5, 2, 4, 7, 5)), -4, hw + 8
    isz = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(shift)
    src = torch.from_numpy(rng.integers(-127, 128, b * hw * F + 64)) \
        .to(cuda, dtype)
    flat = src[shift // isz:shift // isz + b * hw * F].view(b, hw, F)
    n_out = b * n_rows * len(offs) * F
    dst = torch.zeros(n_out + 64, dtype=dtype, device=cuda)
    out = dst[shift // isz:shift // isz + n_out].view(b, n_rows, -1)
    assert flat.data_ptr() % 16 == shift and out.data_ptr() % 16 == shift
    before = tpack.pack_rows.launches
    tpack.pack_rows_into(out, flat, offs, row0)
    torch.cuda.synchronize()
    assert tpack.pack_rows.launches == before + 1
    assert _same_bits(out, tpack.pack_rows_plain(flat, offs, row0, n_rows))
    # nothing written outside the slice
    assert not dst[:shift // isz].any() and not dst[shift // isz + n_out:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k64_f32_96_bytes", "ragged_n_rows",
                                  "wide_rows_in_groups"])
def test_pack_kernel_edge_tilings(cuda, case):
    """K = 64 offsets of 96-byte f32 rows; ``n_rows`` that no tile divides
    (the last tile ragged, rows past the table zero); rows too wide for one
    output row to fit the staging, so the offsets are cut into groups."""
    rng = np.random.default_rng(3)
    if case == "k64_f32_96_bytes":
        b, hw, F, dtype = 2, 5000, 24, torch.float32
        offs, row0, n_rows = tuple(range(-300, 340, 10)), -5, 5003
    elif case == "ragged_n_rows":
        b, hw, F, dtype = 3, 4099, 9, torch.float16
        offs, row0, n_rows = (0, 1, 97, 98), 2, 4099 + 113
    else:
        b, hw, F, dtype = 1, 50, 5000, torch.float32
        offs, row0, n_rows = (0, 3, -2, 40), 0, 45
    plan = tpack.tile_plan(offs, F * torch.empty((), dtype=dtype)
                           .element_size(), n_rows)
    assert n_rows % plan.rows or case != "ragged_n_rows"
    assert (len(plan.group_k) > 2) == (case == "wide_rows_in_groups")
    flat = torch.from_numpy(rng.integers(-127, 128, (b, hw, F))).to(cuda,
                                                                    dtype)
    got = tpack.pack_rows(flat, offs, row0, n_rows)
    torch.cuda.synchronize()
    assert _same_bits(got, tpack.pack_rows_plain(flat, offs, row0, n_rows))


@pytest.mark.cuda
def test_pack_kernel_refuses_a_strided_table(cuda):
    flat = torch.zeros(1, 24, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tpack.pack_rows(flat.transpose(1, 2), (0, 1))


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: launches on a card that is not "
                    "the current one")
    return torch.device("cuda:0"), torch.device("cuda:1")


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(two_cards):
    """Each wrapper with ``cuda:1`` current and its tensors on ``cuda:0``:
    the kernels must launch on the tensors' card (the wrapper makes it
    current; kernel A opts in to its shared memory there, ``gn_solve``
    sizes its grid for it) and agree with their plain versions as above."""
    dev0, dev1 = two_cards
    rng = np.random.default_rng(0)
    qkv = [torch.from_numpy(rng.standard_normal((1, 12, 768, 64))
                            .astype(np.float32)).to(dev0, torch.bfloat16)
           for _ in range(3)]
    pre, T = testing.gn_problem(196608, 196608, dev0)
    cfg = TrackerConfig()
    flat = torch.from_numpy(rng.integers(-127, 128, (1, 4096, 24))).to(
        dev0, torch.int8)
    with torch.cuda.device(dev1):
        out = tattn.flash_attention(*qkv)
        sums = tgn.gn_sums(pre.pts, tgn.rot_scalars(T), 1.345)
        T1, ok1, it1 = tgn.gn_solve(pre, T, cfg)
        packed = tpack.pack_rows(flat, (0, 1, 64, 65), 0, 4096)
    torch.cuda.synchronize(dev0)
    assert out.device == sums.device == packed.device == dev0
    ref = tattn.attention_plain(*qkv)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    err, tol = testing.gn_sums_check(
        sums, tgn.gn_terms_plain(pre.pts, tgn.rot_scalars(T), 1.345))
    assert bool((err <= tol).all())
    Tp, okp, itp = tgn.gn_solve_plain(pre, T, cfg)
    assert ok1 == okp and it1 == itp
    assert float((T1 - Tp).abs().max()) <= 1e-5
    assert _same_bits(packed, tpack.pack_rows_plain(flat, (0, 1, 64, 65), 0,
                                                    4096))
