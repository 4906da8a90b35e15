"""The probe-table pack against the JAX package.

``pack_rows_plain`` (the CUDA kernel's plain version, and what ``pack_rows``
runs on a CPU tensor) must equal the Pallas ``pack_rows_mxu`` run in TPU
interpret mode on every row, bit for bit (it is a copy: no tolerance), equal
the wrap build ``pack_rows_roll`` on the rows whose sources stay inside the
table, and follow ``row0`` / ``n_rows`` as a numpy loop states them.  Inputs
come from ``np.random.default_rng(seed)``; the same arrays go to both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mast3r_slam_tpu.ops import pack as jpack
from mast3r_slam_torch.ops import pack as tpack

H, W, F = 16, 32, 24          # hw = 512: one row tile of the Pallas kernel


def _table(dtype, seed=0, b=1, hw=H * W, f=F):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return rng.integers(-127, 128, (b, hw, f)).astype(np.int8)
    return rng.standard_normal((b, hw, f)).astype(dtype)


def _loop(flat, offsets, row0, n_rows):
    b, hw, f = flat.shape
    out = np.zeros((b, n_rows, len(offsets) * f), flat.dtype)
    for r in range(n_rows):
        for k, off in enumerate(offsets):
            src = r + row0 + off
            if 0 <= src < hw:
                out[:, r, k * f:(k + 1) * f] = flat[:, src]
    return out


def _window_offsets():
    # the corner pack and two probe windows of refine_matches
    return {
        "corners": (0, 1, W, W + 1),
        "r3_d2_p2": tuple(tpack._offsets(7, 2, 6, W, 2)),
        "r1_d1_p3": tuple(tpack._offsets(3, 1, 1, W, 3)),
    }


def test_offsets_match_jax():
    for args in [(7, 4, 12, 64, 2), (5, 2, 4, 64, 5), (3, 1, 1, 512, 3)]:
        assert tpack._offsets(*args) == jpack._offsets(*args)


@pytest.mark.parametrize("name", ["corners", "r3_d2_p2", "r1_d1_p3"])
@pytest.mark.parametrize("dtype", [np.int8, np.float16, np.float32],
                         ids=["int8", "f16", "f32"])
def test_plain_equals_pallas_kernel_on_all_rows(dtype, name):
    """Bitwise on every row, the zero-filled border rows included."""
    offsets = _window_offsets()[name]
    flat = _table(dtype, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpack.pack_rows_mxu(jnp.asarray(flat), offsets))
    out = tpack.pack_rows(torch.from_numpy(flat), offsets).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert out.tobytes() == ref.tobytes()


@pytest.mark.parametrize("dtype", [np.int8, np.float16, np.float32],
                         ids=["int8", "f16", "f32"])
def test_plain_equals_roll_on_interior_rows(dtype):
    """The wrap build differs only in rows whose source leaves [0, hw)."""
    offsets = _window_offsets()["r3_d2_p2"]
    flat = torch.from_numpy(_table(dtype, seed=2, b=2))
    plain = tpack.pack_rows_plain(flat, offsets)
    roll = tpack.pack_rows_roll(flat, offsets)
    lo, hi = -min(offsets), H * W - max(offsets)
    assert torch.equal(plain[:, lo:hi], roll[:, lo:hi])
    assert not torch.equal(plain, roll)
    np.testing.assert_array_equal(
        roll.numpy(), np.asarray(jpack.pack_rows_roll(
            jnp.asarray(flat.numpy()), offsets)))


@pytest.mark.parametrize("row0,n_rows", [(0, None), (-12, H * W + 24),
                                         (5, 40), (H * W - 3, 10)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_row0_and_n_rows_against_a_numpy_loop(dtype, row0, n_rows):
    offsets = (-W - 1, 0, 3, 2 * W, 2 * H * W + 7, -2 * H * W - 2)
    flat = torch.from_numpy(_table(np.float32, seed=3, b=2, f=5) * 20) \
        .to(dtype)
    out = tpack.pack_rows(flat, offsets, row0=row0, n_rows=n_rows)
    as_np = flat.view(torch.int16).numpy() if dtype == torch.bfloat16 \
        else flat.numpy()
    ref = _loop(as_np, offsets, row0, H * W if n_rows is None else n_rows)
    got = out.view(torch.int16).numpy() if dtype == torch.bfloat16 \
        else out.numpy()
    np.testing.assert_array_equal(got, ref)
    # blocks whose every source row is outside the table are all zero
    assert not got[..., 4 * 5:].any()


def test_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    before = tpack.pack_rows.launches
    tpack.pack_rows(torch.zeros(1, 8, 2), (0, 1))
    assert tpack.pack_rows.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tpack.pack_rows(torch.zeros(1, 8, 2, device="meta"), (0, 1))


# ---------------------------------------------------------------------------
# The kernel's tiling (csrc/pack.cu runs only on the card; its plan is made
# on the host and checked here through a plain assembly that follows it)
# ---------------------------------------------------------------------------

PLAN_CASES = {  # name: (offsets, row bytes, n_rows, row0, F, dtype)
    "lm corners f16": ((0, 1, W, W + 1), 18, H * W, 0, 9, torch.float16),
    "refine d=4 r=3 p=2 int8": (tuple(tpack._offsets(7, 4, 12, W, 2)), 24,
                                H * W + 24, -12, 24, torch.int8),
    "refine d=2 r=2 p=5 int8": (tuple(tpack._offsets(5, 2, 4, W, 5)), 24,
                                H * W + 8, -4, 24, torch.int8),
    "refine d=1 r=1 p=3 int8": (tuple(tpack._offsets(3, 1, 1, W, 3)), 24,
                                H * W + 2, -1, 24, torch.int8),
    "K=64 f32 96-byte rows": (tuple(range(-200, 248, 7)), 96, 301, 3, 24,
                              torch.float32),
    "duplicates, beyond the table": ((5, 5, -H * W - 3, 2 * H * W, 0), 5,
                                     77, -2, 5, torch.int8),
    "wide rows cut into groups": ((0, 3, -2, 40), 20000, 9, 0, 5000,
                                  torch.float32),
}


def _assemble_plain(flat, offsets, row0, n_rows, plan):
    """The kernel's steps on the CPU: per tile and group, each span's rows
    staged once (zeros outside the table), then every offset's block read
    from its span at its delta."""
    b, hw, F = flat.shape
    K = len(offsets)
    R = plan.rows
    out = torch.full((b, n_rows, K, F), 99, dtype=torch.uint8) \
        .to(flat.dtype)
    for r0 in range(0, n_rows, R):
        rows = min(R, n_rows - r0)
        for g in range(len(plan.group_k) - 1):
            staged = {}
            for s in range(plan.group_span[g], plan.group_span[g + 1]):
                first = r0 + row0 + plan.span_lo[s]
                buf = flat.new_zeros((b, plan.span_rows[s], F))
                a = max(first, 0)
                e = min(first + plan.span_rows[s], hw)
                if e > a:
                    buf[:, a - first:e - first] = flat[:, a:e]
                staged[s] = buf
            for k in range(plan.group_k[g], plan.group_k[g + 1]):
                d = plan.k_delta[k]
                out[:, r0:r0 + rows, k] = staged[plan.k_span[k]][:, d:d + rows]
    return out.reshape(b, n_rows, K * F)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_tile_plan_covers_every_window_and_reproduces_plain(name):
    """Every offset's R-row window lies inside its span, the spans of a
    group sit apart in the staging within the block's budget, the groups
    cover the K offsets in order, and the plan's assembly equals
    ``pack_rows_plain`` bit for bit."""
    offsets, row_bytes, n_rows, row0, F, dtype = PLAN_CASES[name]
    assert F * torch.empty((), dtype=dtype).element_size() == row_bytes
    plan = tpack.tile_plan(offsets, row_bytes, n_rows)
    R, K = plan.rows, len(offsets)
    assert plan.group_k[0] == 0 and plan.group_k[-1] == K
    assert list(plan.group_k) == sorted(plan.group_k)
    assert len(plan.group_k) == 2 or R == 1
    for g in range(len(plan.group_k) - 1):
        spans = range(plan.group_span[g], plan.group_span[g + 1])
        for k in range(plan.group_k[g], plan.group_k[g + 1]):
            s = plan.k_span[k]
            assert s in spans
            assert plan.span_lo[s] + plan.k_delta[k] == offsets[k]
            assert 0 <= plan.k_delta[k] and \
                plan.k_delta[k] + R <= plan.span_rows[s]
        end = 0
        for s in spans:
            assert plan.span_smem[s] % 16 == 0 and plan.span_smem[s] >= end
            end = plan.span_smem[s] + tpack._round16(
                plan.span_rows[s] * row_bytes) + 16
        assert end <= plan.smem <= tpack._MAX_SMEM_BYTES
    if len(plan.group_k) == 2:
        assert plan.smem <= tpack._TILE_SMEM_BYTES
    rng = np.random.default_rng(len(name))
    flat = torch.from_numpy(rng.integers(-127, 128, (2, H * W, F))).to(dtype)
    got = _assemble_plain(flat, offsets, row0, n_rows, plan)
    ref = tpack.pack_rows_plain(flat, offsets, row0, n_rows)
    assert got.view(torch.uint8).equal(ref.view(torch.uint8))


def test_tile_plan_of_the_production_tables():
    """At 384x512: the LM corner table is 2 spans of R+1 rows, a refine
    table 2r+1 spans of R+(P-1)*d rows, and each tile's output is a
    multiple of 16 bytes."""
    w, hw = 512, 384 * 512
    lm = tpack.tile_plan((0, 1, w, w + 1), 18, hw)
    assert len(lm.span_lo) == 2 and set(lm.span_rows) == {lm.rows + 1}
    assert lm.rows * 4 * 18 % 16 == 0
    for r, d, P in ((3, 4, 2), (2, 2, 5), (1, 1, 3)):
        offs = tuple(tpack._offsets(2 * r + 1, d, r * d, w, P))
        plan = tpack.tile_plan(offs, 24, hw + 2 * r * d)
        assert len(plan.span_lo) == 2 * r + 1
        assert set(plan.span_rows) == {plan.rows + (P - 1) * d}
        assert plan.rows * len(offs) * 24 % 16 == 0


def test_pack_rows_into_refuses_cpu_tensors():
    flat = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tpack.pack_rows_into(torch.zeros(1, 8, 4), flat, (0, 1))
