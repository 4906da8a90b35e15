"""The matcher against the JAX ``match``, at the reference-exact and the
production knobs.

Same seeded pointmaps and descriptors go through both packages.

* ``refine_matches`` (packed tables) is exact: on the same starting pixels,
  border and corner pixels included, both packages pick the same window
  maximum, ties included, for every (radius, dilation, u_pack, coarse_bits,
  table dtype) the shipped configs use; and the packed path equals the
  probe-by-probe statement ``refine_matches_probes``.  The bf16 case uses
  descriptors on a 1/16 grid, so every dot product is exact in f32 whatever
  the order of its sum.
* ``match`` after the LM stage is integer or exactly rounded arithmetic:
  fed the JAX ``iter_proj`` output, ``match_after_lm`` returns the JAX
  ``idx`` and ``valid`` bit for bit.
* With each side's own LM, indices and validity agree on at least 99.5% of
  the pixels (99.9% at the reference-exact knobs), not all: the JAX
  ``iter_proj`` is compiled, and XLA:CPU contracts ``a*b + c`` into fused
  multiply-adds where PyTorch does not, so an LM position that lands within
  a few ulp of an integer can truncate to the neighbouring pixel, and under
  the production knobs one such flip on the quarter grid is interpolated
  onto up to 16 pixels.  Measured on this scene: ``valid`` identical on 100%
  of the pixels at all five knob sets; ``idx`` identical on 100% at three of
  them, 99.98% with the half-res LM table and 99.74% with bf16 tables and
  no final pass (where nothing after the coarse walk pulls a flipped
  position back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import matching as jm
from mast3r_slam_torch.ops import matching as tm
from mast3r_slam_torch.utils.config import (REFERENCE_EXACT_OVERRIDES,
                                            load_config, merge_config)

AGREE = 0.999
AGREE_PRODUCTION = 0.995
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


def _reference_exact_block():
    """``config/base.yaml``'s matching block at the reference-exact knobs."""
    return merge_config(
        load_config("config/base.yaml"),
        {"matching": REFERENCE_EXACT_OVERRIDES["matching"]})["matching"]


def _configs(block=None):
    block = block or _reference_exact_block()
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


def _start_pixels(seed):
    """Random start pixels, with the four borders and corners of the image
    among them."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.integers(0, W, H * W), rng.integers(0, H, H * W)], -1)
    p[:W, 0], p[:W, 1] = np.arange(W), 0
    p[W:2 * W, 0], p[W:2 * W, 1] = np.arange(W), H - 1
    p[2 * W:2 * W + H, 0], p[2 * W:2 * W + H, 1] = 0, np.arange(H)
    p[2 * W + H:2 * W + 2 * H, 0] = W - 1
    p[2 * W + H:2 * W + 2 * H, 1] = np.arange(H)
    return p[None].astype(np.int32)


def test_refine_matches_is_exact():
    X1, X2, D1, D2 = _scene(2, 5)
    p = _start_pixels(2)
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


# (radius, dilation_max, dilation_min, u_pack, coarse_bits, table dtype):
# the stages of config/base.yaml (first scheduled dilation, inner dilation,
# final pass), the reference-exact ladder, and the same stages under the
# coarse_bits 4 and desc_bits 16 options
REFINE_CASES = [
    (3, 4, 4, 2, 8, "int8"), (2, 2, 2, 5, 8, "int8"), (1, 1, 1, 3, 8, "int8"),
    (3, 5, 1, 2, 8, "int8"), (3, 4, 4, 2, 4, "int8"), (2, 3, 2, 5, 4, "int8"),
    (3, 4, 4, 2, 8, "bf16"), (1, 1, 1, 3, 8, "bf16"),
]


@pytest.mark.parametrize("radius,d_max,d_min,u_pack,bits,dtype",
                         REFINE_CASES)
def test_refine_matches_packed_equals_jax_and_probes(radius, d_max, d_min,
                                                     u_pack, bits, dtype):
    """Exact equality with the JAX ``refine_matches`` for every query, the
    ones on the image border included, where the JAX version's wrapped
    table rows matter; and with ``refine_matches_probes``."""
    _, _, D1, D2 = _scene(3, 5)
    p = _start_pixels(radius * 10 + d_max)
    D2 = D2.reshape(1, H * W, F)
    if dtype == "int8":
        t1, t2 = tm._q8_pair(torch.from_numpy(D1), torch.from_numpy(D2))
        j1, j2 = jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy())
    else:
        g1, g2 = np.round(D1 * 16) / 16, np.round(D2 * 16) / 16
        t1 = torch.from_numpy(g1).to(torch.bfloat16)
        t2 = torch.from_numpy(g2).to(torch.bfloat16)
        j1 = jnp.asarray(g1, jnp.bfloat16)
        j2 = jnp.asarray(g2, jnp.bfloat16)
    kw = dict(radius=radius, dilation_max=d_max, dilation_min=d_min,
              u_pack=u_pack, coarse_bits=bits)
    rj, sj = jm.refine_matches(j1, j2, jnp.asarray(p), return_score=True,
                               **kw)
    rt, st = tm.refine_matches(t1, t2, torch.from_numpy(p),
                               return_score=True, **kw)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    moved = (rt.numpy() != p).any(-1).mean()
    assert moved > 0.5, moved
    if bits == 8:
        rp = tm.refine_matches_probes(t1, t2, torch.from_numpy(p),
                                      radius=radius, dilation_max=d_max,
                                      dilation_min=d_min)
        assert torch.equal(rp, rt)


def _base_block(**over):
    block = dict(load_config("config/base.yaml")["matching"])
    block.update(over)
    return block


# config/base.yaml's block as written, then further knob sets: the
# half-grid walk alone at the full ladder; a non-contiguous schedule with
# the half-res LM table, nibble tables and a radius-2 final pass; bf16
# tables with no final pass; and the subgrid output of factor-graph edges
MATCH_CASES = {
    "base_yaml": (_base_block(), 1),
    "coarse_only": (_base_block(
        final_radius=0, coarse_radius=0, dilation_schedule=[],
        lm_subsample=0, occlusion_subsample=1), 1),
    "schedule_542_lmt_int4": (_base_block(
        dilation_schedule=[5, 4, 2], lm_table_subsample=2, coarse_bits=4,
        final_radius=2), 1),
    "bf16_no_final": (_base_block(desc_bits=16, final_radius=-1), 1),
    "query_subsample": (_base_block(), 2),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_production_knobs(case, monkeypatch):
    block, qsub = MATCH_CASES[case]
    jcfg, tcfg = _configs(block)
    assert jcfg._asdict() == tcfg._asdict()
    X1, X2, D1, D2 = _scene(4, 6)
    idx0 = np.arange(H * W)[None]
    lm = {}
    iter_proj = jm.iter_proj

    def spy(*a, **kw):
        lm["out"] = iter_proj(*a, **kw)
        return lm["out"]

    monkeypatch.setattr(jm, "iter_proj", spy)
    jidx, jval = jm.match(
        *map(jnp.asarray, (X1, X2, D1, D2, idx0.astype(np.int32))),
        cfg=jcfg, query_subsample=qsub)
    jidx, jval = np.asarray(jidx), np.asarray(jval)
    t_in = list(map(torch.from_numpy, (X1, X2, D1, D2)))

    # everything after the LM, on the JAX LM's output: bit for bit
    p_lm, ok_lm = (torch.from_numpy(np.array(a)) for a in lm["out"])
    tidx, tval = tm.match_after_lm(*t_in, p_lm, ok_lm, tcfg,
                                   query_subsample=qsub)
    assert tidx.shape == jidx.shape and tval.shape == jval.shape
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tval.numpy(), jval)

    # each side's own LM
    tidx, tval = tm.match(*t_in, torch.from_numpy(idx0), cfg=tcfg,
                          query_subsample=qsub)
    assert (tidx.numpy() == jidx).mean() >= AGREE_PRODUCTION
    assert (tval.numpy() == jval).mean() >= AGREE_PRODUCTION
    n_out = H * W // (4 if qsub == 2 else 1)
    assert jidx.shape == (1, n_out)
    assert jval.mean() > 0.85


@pytest.mark.parametrize("knob,value", [
    ("coarse_subsample", 2), ("lm_subsample", 4), ("lm_table_subsample", 2),
    ("final_radius", 1), ("dilation_schedule", [4, 2]), ("coarse_bits", 4),
])
def test_matching_config_refuses_unported_knobs(knob, value):
    """No knob of the matching block is left unported: each value that the
    first slice of the port refused is now taken and stored as the JAX
    ``MatchingConfig`` stores it."""
    block = dict(_reference_exact_block())
    block[knob] = value
    tcfg = tm.MatchingConfig.from_dict(block)
    jcfg = jm.MatchingConfig.from_dict(block)
    assert getattr(tcfg, knob) == getattr(jcfg, knob)
    assert getattr(tcfg, knob) == (tuple(value) if isinstance(value, list)
                                   else value)
