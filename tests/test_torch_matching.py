"""The reference-exact matcher against the JAX ``match``.

Same seeded pointmaps and descriptors go through both packages with the
slice's matching configuration (``coarse_subsample 1``, int8 descriptor
tables).  Match indices and validity must be identical on at least 99.9%
of the pixels, not all: the JAX ``iter_proj`` is compiled, and XLA:CPU
contracts ``a*b + c`` into fused multiply-adds where PyTorch does not, so
an LM position that lands within a few ulp of an integer can truncate to
the neighbouring pixel.  The descriptor refine is exact: on the same
starting pixels both packages pick the same window maximum, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import matching as jm
from mast3r_slam_torch.ops import matching as tm
from mast3r_slam_torch.utils.config import frontend_config

AGREE = 0.999
H, W, F = 96, 128, 24


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _scene(seed, shift):
    """A smooth textured surface seen from two views ``shift`` pixels
    apart, with smooth unit descriptors that move with the surface."""
    rng = np.random.default_rng(seed)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W + shift), indexing="ij")
    z = 2.0 + 0.3 * np.sin(uu / 9.0) * np.cos(vv / 7.0)
    X = np.stack([(uu - W / 2) / 100.0 * z, (vv - H / 2) / 100.0 * z, z], -1)
    freq = rng.uniform(0.05, 0.4, (F, 2))
    phase = rng.uniform(0, 2 * np.pi, F)
    D = np.sin(uu[..., None] * freq[:, 0] + vv[..., None] * freq[:, 1]
               + phase)
    D = _normalize(D + 0.05 * rng.standard_normal(D.shape))
    X1, X2 = X[:, shift:], X[:, :W]
    D1, D2 = D[:, shift:], D[:, :W]
    return tuple(a[None].astype(np.float32) for a in (X1, X2, D1, D2))


def _configs():
    block = frontend_config("config/base.yaml")["matching"]
    return jm.MatchingConfig.from_dict(block), tm.MatchingConfig.from_dict(
        block)


@pytest.mark.parametrize("seed,shift", [(0, 3), (1, 7)])
def test_match_agrees_with_jax(seed, shift):
    X1, X2, D1, D2 = _scene(seed, shift)
    jcfg, tcfg = _configs()
    assert jcfg.coarse_subsample == 1 and jcfg.desc_bits == 8
    idx0 = np.arange(H * W)[None]
    jidx, jval = jax.jit(lambda *a: jm.match(*a, cfg=jcfg))(
        *map(jnp.asarray, (X1, X2, D1, D2, idx0.astype(np.int32))))
    tidx, tval = tm.match(*map(torch.from_numpy, (X1, X2, D1, D2, idx0)),
                          cfg=tcfg)
    jidx, jval = np.asarray(jidx), np.asarray(jval)
    assert tidx.shape == jidx.shape and tval.shape == jval.shape
    assert (tidx.numpy() == jidx).mean() >= AGREE
    assert (tval.numpy() == jval).mean() >= AGREE
    # the scene is matchable: most pixels are valid and found the shift
    assert jval.mean() > 0.9
    assert (jidx == idx0 - shift).mean() > 0.9


def test_refine_matches_is_exact():
    X1, X2, D1, D2 = _scene(2, 5)
    rng = np.random.default_rng(2)
    p = np.stack([rng.integers(0, W, H * W), rng.integers(0, H, H * W)],
                 -1)[None].astype(np.int32)
    jq1, jq2 = jm._q8_pair(jnp.asarray(D1), jnp.asarray(D2).reshape(1, H * W,
                                                                     F))
    tq1, tq2 = tm._q8_pair(torch.from_numpy(D1),
                           torch.from_numpy(D2).reshape(1, H * W, F))
    np.testing.assert_array_equal(tq1.numpy(), np.asarray(jq1))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    rj = jm.refine_matches(jq1, jq2, jnp.asarray(p), radius=3,
                           dilation_max=5)
    rt = tm.refine_matches(tq1, tq2, torch.from_numpy(p), radius=3,
                           dilation_max=5)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("knob,value", [
    ("coarse_subsample", 2), ("lm_subsample", 4), ("lm_table_subsample", 2),
    ("final_radius", 1), ("dilation_schedule", [4, 2]), ("coarse_bits", 4),
])
def test_matching_config_refuses_unported_knobs(knob, value):
    block = dict(frontend_config("config/base.yaml")["matching"])
    block[knob] = value
    with pytest.raises(NotImplementedError, match=knob):
        tm.MatchingConfig.from_dict(block)
