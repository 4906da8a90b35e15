"""The ported MASt3R network against the JAX model, f32, atol 1e-4.

The tiny configuration covers the whole network: the JAX model's own
seeded Flax init is converted with ``params_from_jax`` and loaded strictly
into the port.  A second case runs the trunk at ViT-L widths (1024 with 16
heads, 768 with 12 heads, so Dh = 64 as on the card) at depth 1, with the
weights going the other way: the port's seeded init, keyed like the
published checkpoint, through the JAX package's ``convert_state_dict``.
Both sides then encode the same images and decode the same pair through
both heads.

The tolerance is atol 1e-4 on outputs of magnitude up to 1, and 1e-4 of
the largest magnitude beyond that: the pointmap is ``expm1`` of the head's
norm, which reaches ~20 with random weights and scales the rounding of the
f32 head with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_torch.models.convert import params_from_jax, \
    prepare_checkpoint
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

ATOL = 1e-4
OUT_KEYS = ("pts3d", "conf", "desc", "desc_conf")

CASES = {  # name: (config overrides, image size, where the weights start)
    "tiny": (dict(), (64, 96), "jax"),
    "vit_large_widths": (dict(enc_embed_dim=1024, enc_num_heads=16,
                              dec_embed_dim=768, dec_num_heads=12,
                              enc_depth=1, dec_depth=1), (32, 48), "torch"),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    kw, hw, source = CASES[request.param]
    jcfg = JaxConfig.tiny(**kw)
    jmodel = JaxMASt3R(jcfg)
    torch.manual_seed(0)
    model = MASt3R(MASt3RConfig.tiny(**kw))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (2, 1, hw[0], hw[1], 3)).astype(np.float32)
    if source == "jax":
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(imgs[0]),
                                      jnp.asarray(imgs[1]))
        model.load_state_dict(
            params_from_jax(jax.tree.map(np.asarray, params)))
    else:
        params = convert_state_dict(model.state_dict(), jcfg.enc_depth,
                                    jcfg.dec_depth)
    return jmodel, params, model.eval(), imgs, hw


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=ATOL * max(1.0, np.abs(j).max()))


def _jax_encode(jmodel, params, img):
    return jax.jit(lambda p, x: jmodel.apply(p, x, method=JaxMASt3R.encode))(
        params, jnp.asarray(img))


def test_encode_matches_jax(pair):
    jmodel, params, model, imgs, _ = pair
    for img in imgs:
        fj, pj = _jax_encode(jmodel, params, img)
        with torch.no_grad():
            ft, pt = model.encode(torch.from_numpy(img))
        _close(ft, fj)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_decode_and_head_match_jax(pair):
    jmodel, params, model, imgs, hw = pair
    encj = [_jax_encode(jmodel, params, i) for i in imgs]
    resj = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, hw, method=JaxMASt3R.decode_and_head))(params, *encj[0],
                                                       *encj[1])
    with torch.no_grad():
        enct = [model.encode(torch.from_numpy(i)) for i in imgs]
        rest = model.decode_and_head(*enct[0], *enct[1], hw)
    for rj, rt in zip(resj, rest):
        for key in OUT_KEYS:
            assert rt[key].shape == rj[key].shape, key
            _close(rt[key], rj[key])


def test_prepare_checkpoint_duplicates_dec_blocks():
    """A checkpoint without ``dec_blocks2`` gets a copy of ``dec_blocks``
    and loses the tensors the reference never uses."""
    sd = {"dec_blocks.0.norm1.weight": torch.ones(3),
          "enc_pos_embed": torch.zeros(2), "mask_token": torch.zeros(1)}
    out = prepare_checkpoint(sd)
    assert set(out) == {"dec_blocks.0.norm1.weight",
                        "dec_blocks2.0.norm1.weight"}
    assert torch.equal(out["dec_blocks2.0.norm1.weight"], torch.ones(3))
