"""A published MASt3R checkpoint file loads into the port as the JAX
package converts it.

The file is forged (``tests/test_convert_parity.py::make_state_dict``, the
tiny configuration, so nothing is downloaded) in three layouts:

* ``published``: ``{"args": Namespace(model=...), "model": sd}`` with its
  own ``dec_blocks2`` weights, the DPT's ``scratch.layer_rn.{i}`` alias keys
  and ``mask_token``, as a MASt3R training run saves it;
* ``croco``: the same wrapper without ``dec_blocks2`` or aliases (the
  reference duplicates ``dec_blocks``);
* ``bare``: the published state dict saved on its own.

For each, the port's ``models/convert.py::load_checkpoint`` must give
``params_from_jax(convert_state_dict(load_torch_checkpoint(f)[0],
strict=True))`` of the JAX package bitwise, but for the 8 tensors of both
heads' ``refinenet4.resConfUnit1``, which have no skip input to act on: JAX
drops them (``params_from_jax`` fills zeros) and the port keeps the file's.
An encode and a decode of the loaded model then agree with JAX's on the same
file within ``tests/test_torch_model.py``'s tolerance, atol 1e-4 on outputs
up to 1 and 1e-4 of the largest magnitude beyond.  An alias that differs
from its conv and a key that nothing consumes fail on both sides.
``main_torch.main`` and ``main_quantized_torch.main`` reach the real
``load_model`` branch with ``MASt3RConfig.vit_large`` swapped for ``tiny``:
the engine they run holds the file's weights (and the int8 engine codes
quantised from them).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_quantized_torch
import main_torch
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.convert import \
    load_torch_checkpoint as jax_load_torch_checkpoint
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_torch import testing
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models import convert
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
from test_convert_parity import make_state_dict

ATOL = 1e-4
OUT_KEYS = ("pts3d", "conf", "desc", "desc_conf")
HW = (32, 48)
JCFG = JaxConfig.tiny()
MODEL_ARGS = ("AsymmetricMASt3R(enc_depth=2, dec_depth=4, "
              "enc_embed_dim=64, dec_embed_dim=48, head_type='catmlp+dpt')")
# the weights that no input reaches: refinenet4 has no skip path
DEAD = sorted(f"downstream_head{n}.dpt.scratch.refinenet4.resConfUnit1."
              f"{c}.{p}" for n in (1, 2) for c in ("conv1", "conv2")
              for p in ("weight", "bias"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def published_state_dict():
    """The forged state dict as a MASt3R run saves it: ``dec_blocks2`` with
    weights of its own, the ``scratch.layer_rn`` aliases and the CroCo
    ``mask_token``."""
    sd = make_state_dict(0)
    other = make_state_dict(1)
    for k, v in other.items():
        if k.startswith("dec_blocks."):
            sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = v
    for n in (1, 2):
        for i in range(4):
            pre = f"downstream_head{n}.dpt.scratch"
            sd[f"{pre}.layer_rn.{i}.weight"] = sd[f"{pre}.layer{i + 1}_rn.weight"]
    sd["mask_token"] = torch.zeros(1, 1, JCFG.enc_embed_dim)
    return sd


LAYOUTS = {
    "published": lambda: {"args": argparse.Namespace(model=MODEL_ARGS),
                          "model": published_state_dict()},
    "croco": lambda: {"args": argparse.Namespace(model=MODEL_ARGS),
                      "model": make_state_dict(0)},
    "bare": published_state_dict,
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def ckpt(request, tmp_path_factory):
    """(layout, file, the port's model loaded from it, JAX's params of the
    same file)."""
    path = tmp_path_factory.mktemp("ckpt") / f"{request.param}.pth"
    torch.save(LAYOUTS[request.param](), path)
    model = convert.load_checkpoint(MASt3R(MASt3RConfig.tiny()), path)
    jsd, _ = jax_load_torch_checkpoint(str(path))
    params = convert_state_dict(jsd, JCFG.enc_depth, JCFG.dec_depth,
                                strict=True)
    return request.param, path, model.eval(), params


def test_checkpoint_loads_as_jax_converts_it(ckpt):
    layout, path, model, params = ckpt
    sd, args = convert.load_torch_checkpoint(path)
    assert args == ("" if layout == "bare" else MODEL_ARGS)
    ref = convert.params_from_jax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    differ = sorted(k for k in got if not torch.equal(got[k], ref[k]))
    assert differ == DEAD
    for k in DEAD:
        assert torch.equal(got[k], sd[k])
    if layout == "croco":
        assert all(torch.equal(got[k], got[k.replace("dec_blocks2.",
                                                     "dec_blocks.", 1)])
                   for k in got if k.startswith("dec_blocks2."))
    else:
        assert not torch.equal(got["dec_blocks2.0.attn.qkv.weight"],
                               got["dec_blocks.0.attn.qkv.weight"])


_JMODEL = JaxMASt3R(JCFG)
_jax_encode = jax.jit(lambda p, x: _JMODEL.apply(p, x,
                                                 method=JaxMASt3R.encode))
_jax_decode = jax.jit(lambda p, *a: _JMODEL.apply(
    p, *a, HW, method=JaxMASt3R.decode_and_head))


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=ATOL * max(1.0, np.abs(j).max()))


def test_loaded_model_runs_as_jax(ckpt):
    _, _, model, params = ckpt
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (2, 1, *HW, 3)).astype(np.float32)
    encj = [_jax_encode(params, jnp.asarray(i)) for i in imgs]
    with torch.no_grad():
        enct = [model.encode(torch.from_numpy(i)) for i in imgs]
        rest = model.decode_and_head(*enct[0], *enct[1], HW)
    for (ft, pt), (fj, pj) in zip(enct, encj):
        _close(ft, fj)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    resj = _jax_decode(params, *encj[0], *encj[1])
    for rj, rt in zip(resj, rest):
        for key in OUT_KEYS:
            assert rt[key].shape == rj[key].shape, key
            _close(rt[key], rj[key])


def _bad_alias(sd):
    k = "downstream_head2.dpt.scratch.layer_rn.3.weight"
    sd[k] = sd[k] + 1e-3


def _extra_key(sd):
    sd["enc_blocks.0.attn.extra.weight"] = torch.zeros(3)


@pytest.mark.parametrize("spoil,port_error,jax_error", [
    (_bad_alias, (ValueError, "not an alias of layer4_rn"),
     (ValueError, "not an alias of layer4_rn")),
    (_extra_key, (RuntimeError, "Unexpected key.*attn.extra.weight"),
     (ValueError, "not consumed")),
], ids=["alias-differs", "unknown-key"])
def test_a_bad_checkpoint_fails_on_both_sides(tmp_path, spoil, port_error,
                                              jax_error):
    sd = published_state_dict()
    spoil(sd)
    path = tmp_path / "bad.pth"
    torch.save({"args": argparse.Namespace(model=MODEL_ARGS), "model": sd},
               path)
    with pytest.raises(port_error[0], match=port_error[1]):
        convert.load_checkpoint(MASt3R(MASt3RConfig.tiny()), path)
    with pytest.raises(jax_error[0], match=jax_error[1]):
        convert_state_dict(jax_load_torch_checkpoint(str(path))[0],
                           JCFG.enc_depth, JCFG.dec_depth, strict=True)


@pytest.mark.parametrize("entry", [main_torch, main_quantized_torch],
                         ids=["main_torch", "main_quantized_torch"])
def test_cli_runs_the_checkpoint_file(tmp_path, monkeypatch, entry):
    """``--checkpoint`` through ``load_model``'s ViT-L branch (its config
    swapped for the tiny one) over 2 frames at ``config/base.yaml``: the
    engine holds the file's weights as an engine built from the file
    directly does, bitwise, and ``main_quantized_torch.py``'s int8 codes
    are quantised from them.  The random tiny network need not track."""
    path = tmp_path / "ckpt.pth"
    torch.save(LAYOUTS["published"](), path)
    clip = tmp_path / "clip"
    testing.write_clip(testing.SyntheticSequence(n_frames=2, h=48, w=64),
                       clip)
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    monkeypatch.setattr(MASt3RConfig, "vit_large", MASt3RConfig.tiny)
    systems = []
    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(main_torch, "run", spy)
    rc = entry.main(["--dataset", str(clip), "--config", "config/base.yaml",
                     "--checkpoint", str(path), "--cpu", "--no-viz",
                     "--save-as", "run"])
    assert rc == 0
    engine = systems[0].engine
    int8 = entry is main_quantized_torch
    ref = InferenceEngine(
        convert.load_checkpoint(
            MASt3R(MASt3RConfig.tiny(head_dtype=torch.bfloat16)), path),
        (384, 512), device="cpu", int8_encoder=int8)
    got, want = engine.model.state_dict(), ref.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert engine.model.cfg.head_dtype == torch.bfloat16
    assert (engine.qparams is not None) == int8
    if int8:
        for blk, layers in ref.qparams.items():
            for name, qd in layers.items():
                for a, b in zip(engine.qparams[blk][name], qd):
                    assert torch.equal(a, b), (blk, name)
