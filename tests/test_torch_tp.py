"""Tensor-parallel inference of the port (``InferenceEngine(mesh=)``,
``parallel.mesh.shard_params_tp``) against the JAX package's
tensor-parallel engine and against the port unsharded.

The tiny network with 4 heads in the encoder and the decoders, its
weights from ``torch.manual_seed(0)`` given to both packages (JAX's through
``convert_state_dict``); the port's mesh is (1, 2) on the one CPU, JAX's
(4, 2) on the 8 virtual devices of ``tests/conftest.py``, as
``tests/test_tp_inference.py`` builds it.

Tolerances: JAX's own, atol 1e-4 on the features and atol 1e-4 with rtol
1e-4 on the pointmaps and descriptors (pts3d goes through an exp, so the
order of the partial sums' rounding scales with magnitude).  Measured
(printed with ``-s``): <= 2.2e-6 against JAX's sharded engine, <= 7.2e-7
against the port unsharded.  The int8 encoder split over the mesh is the
unsplit int8 encoder bit for bit (codes, accumulators and outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.inference import InferenceEngine as JaxEngine
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
from mast3r_slam_torch.parallel.mesh import make_mesh

HW = (32, 64)
ATOL = RTOL = 1e-4
HEADS = dict(enc_num_heads=4, dec_num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_engine(sd, mesh=None, **kw):
    model = MASt3R(MASt3RConfig.tiny(**HEADS))
    model.load_state_dict(sd)
    return InferenceEngine(model, HW, device="cpu", mesh=mesh, **kw)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    sd = MASt3R(MASt3RConfig.tiny(**HEADS)).state_dict()
    jcfg = JaxConfig.tiny(**HEADS)
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    jmodel = JaxMASt3R(jcfg)
    img = np.random.default_rng(0).standard_normal(
        (1, HW[0], HW[1], 3)).astype(np.float32)
    return {"sd": sd, "img": img,
            "jax_tp": JaxEngine(jmodel, params, HW,
                                mesh=jmake_mesh(n_edge=4, n_model=2)),
            "port": _port_engine(sd),
            "port_tp": _port_engine(sd, make_mesh(1, 2, ["cpu", "cpu"]))}


def _run(engine, img, to_np):
    f, p = engine.encode(img)
    (X, C, D, Q), _ = engine.decode_pair(f, p, f, p)
    return [to_np(t) for t in (f, X, C, D, Q)]


def test_tp_engine_matches_jax_tp_and_unsharded(nets):
    """Features, pointmaps, confidences, descriptors and their
    confidences of the port's tensor-parallel engine against JAX's
    tensor-parallel engine and against the port unsharded."""
    img = nets["img"]
    ref_j = _run(nets["jax_tp"], jnp.asarray(img), np.asarray)
    tp = _run(nets["port_tp"], torch.from_numpy(img), lambda t: t.numpy())
    one = _run(nets["port"], torch.from_numpy(img), lambda t: t.numpy())
    for name, a, j, o in zip(("feat", "X", "C", "D", "Q"), tp, ref_j, one):
        print(f"{name}: port TP vs JAX TP {np.abs(a - j).max():.3g}, vs "
              f"port unsharded {np.abs(a - o).max():.3g}")
        rtol = 0.0 if name == "feat" else RTOL
        np.testing.assert_allclose(a, j, atol=ATOL, rtol=rtol)
        np.testing.assert_allclose(a, o, atol=ATOL, rtol=rtol)


def test_tp_entries_hold_whole_heads(nets):
    """Each entry holds the q, k and v rows of the same heads (and the
    matching input columns of ``proj``), the biases of ``proj`` and
    ``fc2`` stay whole on the model, and the heads stay unsplit."""
    model = nets["port_tp"].model
    H, n = 4, 2
    for blk in list(model.enc_blocks) + list(model.dec_blocks):
        attn = blk.attn
        W = attn.qkv.weight.reshape(3, H, -1, attn.qkv.weight.shape[1])
        Wp = attn.proj.weight
        Dh = W.shape[2]
        for e, p in enumerate(attn.tp.parts):
            heads = slice(e * H // n, (e + 1) * H // n)
            assert torch.equal(p["qkv_w"].reshape(3, H // n, Dh, -1),
                               W[:, heads])
            assert torch.equal(p["proj_w"],
                               Wp[:, heads.start * Dh:heads.stop * Dh])
            assert set(p) == {"qkv_w", "qkv_b", "proj_w"}
        assert len(blk.mlp.tp.parts) == n
    for blk in model.dec_blocks:
        p0 = blk.cross_attn.tp.parts[0]
        w = blk.cross_attn.projq.weight
        assert torch.equal(p0["projq_w"], w[:w.shape[0] // n])
    assert model.downstream_head1.head_local_features.tp is None


def test_tp_int8_encoder_is_the_unsplit_int8_encoder(nets):
    """``int8_encoder=True`` with the mesh: the split codes are the whole
    weights' codes, and the features equal the unsplit int8 engine's bit
    for bit."""
    img = torch.from_numpy(nets["img"])
    ref = _port_engine(nets["sd"], int8_encoder=True)
    tp = _port_engine(nets["sd"], make_mesh(1, 2, ["cpu", "cpu"]),
                      int8_encoder=True)
    devs, split = tp.qparams_tp
    assert len(devs) == 2
    for name, q8 in ref.qparams.items():
        s8 = split[name]
        w_qkv = torch.cat([s.w_int8.reshape(3, 2, -1, s.w_int8.shape[1])
                           for s in s8["qkv"]], dim=1)
        assert torch.equal(w_qkv.reshape(q8["qkv"].w_int8.shape),
                           q8["qkv"].w_int8)
        for layer in ("proj", "fc2"):
            assert torch.equal(torch.cat([s.w_int8 for s in s8[layer]], 1),
                               q8[layer].w_int8)
        assert torch.equal(torch.cat([s.w_int8 for s in s8["fc1"]]),
                           q8["fc1"].w_int8)
    f_ref, _ = ref.encode(img)
    f_tp, _ = tp.encode(img)
    assert torch.equal(f_tp, f_ref)
