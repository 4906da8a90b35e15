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
