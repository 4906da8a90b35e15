"""The port's int8 network path (``models/quant.py``, the engine's
``int8_encoder`` / ``int8_local_head``) against the JAX package's
``models/quant.py``, on the tiny network with an f32 and a bf16 trunk.

Both packages start from the same weights: the port's seeded init, through
the JAX package's ``convert_state_dict``; the bf16 case casts both sides
with their ``cast_trunk_params_bf16(..., head_bf16=True)`` before anything
is quantised, as both engines do.  Inputs are made with numpy from a seed.

Tolerances (measured on this repo's CPU test box; ``pytest -s`` prints the
figures):

* Quantised weights, int8 activation codes, their scales and the int32
  accumulators: bitwise.  The token scale is amax times the f32 reciprocal
  of 127, as XLA compiles JAX's ``amax / 127.0`` (``quantize_tokens``).
* ``_int8_matmul``'s f32 output on identical inputs: ``MM_RTOL`` of the
  largest magnitude (measured 2.4e-7 absolute on outputs up to ~2, 74-89%
  of the elements bitwise): XLA:CPU contracts the last ``* scale + bias``
  into one fused multiply-add, which PyTorch rounds twice; an FMA model of
  the port's own numbers gives JAX's bits everywhere.
* ``encode_int8``: ``pos`` equal, ``feat`` within ``FEAT_ATOL`` (measured
  2.7e-2 f32 trunk, 3.3e-2 bf16, on features up to 3.7): the same inputs
  reach JAX's compiled encoder with other roundings in the bf16 residual
  stream and attention (its fused program keeps f32 where the source
  rounds to bf16, and its ``dot_product_attention`` is not the port's
  kernel), and a token whose code flips moves by a quantisation step.
  The port's own bf16 fp encoder is 2.8e-2 from JAX's on these inputs.
  JAX's acceptance (``tests/test_quant.py:29-32``) holds on the port: the
  int8 encoder within cosine 0.99 and relative error 0.15 of its fp
  encoder.
* ``local_features_int8`` on identical tokens: ``LOCAL_RTOL`` of the
  largest magnitude (measured below it, see ``-s``).
* The engine with ``int8_local_head``: the DPT outputs as the fp engine's
  to atol 1e-5, descriptor cosine > 0.99 and Q relative error < 0.1
  (``tests/test_quant.py:55-87``).
* The 6-frame clip (``test_torch_frontend.py``'s, reference-exact
  matcher) with the int8 encoder on both sides: equal modes, keyframe
  decisions and stats; poses within ``CLIP_POSE_ATOL`` (measured 1.45e-2,
  5.4e-3 on the keyframes): the features' gap above moves the pointmaps.
  Fed JAX's int8 features frame by frame, the port's poses come within
  ``SHARED_FEAT_POSE_ATOL`` (measured 5.4e-3): the own-matcher LM drift of
  ``ROADMAP.md`` C (3e-3 on the fp frontend's features), so everything
  after the encoder is JAX's but for the matcher's last-bit flips.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.inference import InferenceEngine as JaxEngine
from mast3r_slam_tpu.models import quant as jq
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.models.mast3r import \
    cast_trunk_params_bf16 as jax_cast_bf16
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models import quant as tq
from mast3r_slam_torch.models.convert import quant_params_from_jax
from mast3r_slam_torch.models.mast3r import (MASt3R, MASt3RConfig,
                                             cast_trunk_params_bf16)
from mast3r_slam_torch.utils.config import (REFERENCE_EXACT_OVERRIDES,
                                            load_config, merge_config)
from test_torch_frontend import _clip_inputs, _run_jax, _run_port

HW = (64, 96)
MM_RTOL = 1e-6
FEAT_ATOL = 0.1
LOCAL_RTOL = 1e-6
COS_MIN, REL_MAX = 0.99, 0.15          # tests/test_quant.py:29-32
DESC_COS_MIN, Q_REL_MAX = 0.99, 0.1    # tests/test_quant.py:83-87
CLIP_POSE_ATOL = 5e-2
SHARED_FEAT_POSE_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after: the
    suite runs in several worker processes at once, and PyTorch's thread
    pool in each of them then oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(sd, dtype):
    model = MASt3R(MASt3RConfig.tiny(dtype=dtype, head_dtype=dtype))
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def nets(request):
    """The tiny network on both sides in one dtype (trunk and heads), with
    each package's quantised trees."""
    dt, jdt = getattr(torch, request.param), getattr(jnp, request.param)
    torch.manual_seed(0)
    sd = MASt3R(MASt3RConfig.tiny()).state_dict()
    jcfg = JaxConfig.tiny(dtype=jdt, head_dtype=jdt)
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    model = _port_model(sd, dt)
    if dt == torch.bfloat16:
        params = jax_cast_bf16(params, head_bf16=True)
        cast_trunk_params_bf16(model, head_bf16=True)
    jtrees = {**jq.quantize_encoder_params(params),
              **jq.quantize_local_heads(params)}
    return types.SimpleNamespace(
        tag=request.param, dtype=dt, sd=sd, jcfg=jcfg, params=params,
        model=model, jtrees=jtrees,
        trees={**tq.quantize_encoder_params(model),
               **tq.quantize_local_heads(model)})


def _assert_trees_equal(got, ref):
    assert set(got) == set(ref)
    for name, blk in ref.items():
        assert set(got[name]) == set(blk)
        for layer, qd in blk.items():
            for a, b in zip(got[name][layer], qd):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b), (name, layer)


def test_quantized_weights_equal_jax(nets):
    """``quantize_encoder_params`` and ``quantize_local_heads`` of the port
    give JAX's int8 weights, scales and biases bit for bit."""
    _assert_trees_equal(nets.trees, quant_params_from_jax(nets.jtrees))


def test_quant_params_from_jax_round_trips(nets):
    """``quant_params_from_jax`` turns each (in, out) Flax kernel into the
    (out, in) int8 weight and keeps scale and bias."""
    conv = quant_params_from_jax(nets.jtrees)
    for name, blk in nets.jtrees.items():
        for layer, qd in blk.items():
            got = conv[name][layer]
            assert got.w_int8.dtype == torch.int8
            assert got.w_int8.is_contiguous()
            np.testing.assert_array_equal(got.w_int8.numpy().T,
                                          np.asarray(qd.w_int8))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(qd.scale))
            np.testing.assert_array_equal(got.bias.numpy(),
                                          np.asarray(qd.bias))


@jax.jit
def _jax_codes_and_acc(x, w_int8):
    """What JAX's ``_int8_matmul`` computes before its rescale
    (quant.py:72-81), compiled as it is inside the jitted encoder."""
    x32 = x.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True),
                          1e-12) / 127.0
    x_int8 = jnp.clip(jnp.round(x32 / a_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x_int8, w_int8, dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    return x_int8, a_scale, acc


@pytest.mark.parametrize("name,layer", [
    ("enc_block_0", "qkv"), ("enc_block_1", "fc2"), ("local1", "fc1"),
    ("local2", "fc2")])
def test_int8_matmul_matches_jax_on_identical_inputs(nets, name, layer):
    """Codes, token scales and int32 accumulators bitwise; the f32 output
    to ``MM_RTOL`` of its largest magnitude."""
    qd = nets.trees[name][layer]
    K = qd.w_int8.shape[1]
    x = np.random.default_rng(3).standard_normal((2, 24, K)).astype(
        np.float32)
    jqd = nets.jtrees[name][layer]
    codes, scale, acc = (np.asarray(t) for t in
                         _jax_codes_and_acc(jnp.asarray(x), jqd.w_int8))
    x8, a_scale = tq.quantize_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), codes)
    np.testing.assert_array_equal(a_scale.numpy(), scale)
    acc_t = tq.int_mm(x8.reshape(-1, K), qd.w_int8.t())
    np.testing.assert_array_equal(acc_t.numpy(),
                                  acc.reshape(-1, acc.shape[-1]))
    out_j = np.asarray(jax.jit(jq._int8_matmul)(jnp.asarray(x), jqd))
    out_t = tq._int8_matmul(torch.from_numpy(x), qd).numpy()
    err = np.abs(out_t - out_j).max()
    print(f"{nets.tag} {name}.{layer}: output max abs err {err:.2e} of "
          f"{np.abs(out_j).max():.2f}, {100 * (out_t == out_j).mean():.1f}% "
          f"bitwise")
    assert err <= MM_RTOL * max(1.0, np.abs(out_j).max())


def _images(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, HW[0], HW[1], 3)).astype(np.float32)


def test_encode_int8_matches_jax(nets):
    img = _images(0)
    fj, pj = jax.jit(lambda p, q, x: jq.encode_int8(p, q, x, nets.jcfg))(
        nets.params, nets.jtrees, jnp.asarray(img))
    ft, pt = tq.encode_int8(nets.model, nets.trees, torch.from_numpy(img))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert ft.dtype == torch.float32 and ft.shape == fj.shape
    err = np.abs(ft.numpy() - np.asarray(fj)).max()
    print(f"{nets.tag} encode_int8: feat max abs err {err:.2e} of "
          f"{np.abs(np.asarray(fj)).max():.2f}")
    assert err <= FEAT_ATOL


def _cos_rel(ref, got):
    a = np.asarray(ref, np.float64).reshape(-1)
    b = np.asarray(got, np.float64).reshape(-1)
    return (a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
            np.linalg.norm(a - b) / np.linalg.norm(a))


def test_encode_int8_accepted_against_fp_encoder(nets):
    """JAX's own acceptance of the int8 encoder, on the port."""
    img = torch.from_numpy(_images(0))
    with torch.no_grad():
        f_fp, p_fp = nets.model.encode(img)
    f_q, p_q = tq.encode_int8(nets.model, nets.trees, img)
    assert torch.equal(p_fp, p_q)
    cos, rel = _cos_rel(f_fp.float(), f_q)
    print(f"{nets.tag} int8 against fp encoder: cosine {cos:.6f}, relative "
          f"error {rel:.4f}")
    assert cos > COS_MIN and rel < REL_MAX


def test_local_features_int8_matches_jax(nets):
    cfg = nets.model.cfg
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 24, cfg.enc_embed_dim)).astype(np.float32)
    dec = rng.standard_normal((2, 24, cfg.dec_embed_dim)).astype(np.float32)
    for n in ("local1", "local2"):
        out_j = np.asarray(jax.jit(
            lambda q, e, d: jq.local_features_int8(q, e, d, HW, nets.jcfg))(
                nets.jtrees[n], jnp.asarray(enc), jnp.asarray(dec)))
        out_t = tq.local_features_int8(
            nets.trees[n], torch.from_numpy(enc), torch.from_numpy(dec), HW,
            cfg).numpy()
        assert out_t.shape == out_j.shape == (2, HW[0], HW[1], 25)
        err = np.abs(out_t - out_j).max()
        print(f"{nets.tag} local_features_int8 {n}: max abs err {err:.2e} "
              f"of {np.abs(out_j).max():.2f}, "
              f"{100 * (out_t == out_j).mean():.1f}% bitwise")
        assert err <= LOCAL_RTOL * max(1.0, np.abs(out_j).max())


def test_engine_int8_local_head_accepted(nets):
    """One decode with ``int8_local_head`` against the fp heads of the
    same weights (tests/test_quant.py:55-87)."""
    eng = InferenceEngine(_port_model(nets.sd, nets.dtype), HW, device="cpu")
    eng_q = InferenceEngine(_port_model(nets.sd, nets.dtype), HW,
                            device="cpu", int8_local_head=True)
    assert eng.qlocal is None and eng_q.qparams is None
    _assert_trees_equal(eng_q.qlocal, {k: nets.trees[k]
                                       for k in ("local1", "local2")})
    img1, img2 = (torch.from_numpy(_images(s, 1)) for s in (1, 2))
    (f1, p1), (f2, p2) = eng.encode(img1), eng.encode(img2)
    for (X, C, D, Q), (Xq, Cq, Dq, Qq) in zip(eng.decode_pair(f1, p1, f2, p2),
                                              eng_q.decode_pair(f1, p1, f2,
                                                                p2)):
        np.testing.assert_allclose(Xq.numpy(), X.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(Cq.numpy(), C.numpy(), atol=1e-5, rtol=0)
        cos, _ = _cos_rel(D, Dq)
        _, rel = _cos_rel(Q, Qq)
        print(f"{nets.tag} int8 local head: descriptor cosine {cos:.6f}, Q "
              f"relative error {rel:.4f}")
        assert cos > DESC_COS_MIN and rel < Q_REL_MAX


@pytest.mark.parametrize("head", ["float32", "bfloat16"])
def test_engine_quantizes_after_the_bf16_cast_as_jax(head):
    """Under a bf16 trunk both engines quantise the cast weights: the
    port's ``qparams`` and ``qlocal`` equal JAX's ``InferenceEngine(...,
    int8_encoder=True, int8_local_head=True)``'s bit for bit, and differ
    from a quantisation of the uncast f32 weights."""
    hd, jhd = getattr(torch, head), getattr(jnp, head)
    torch.manual_seed(0)
    sd = MASt3R(MASt3RConfig.tiny()).state_dict()
    jcfg = JaxConfig.tiny(dtype=jnp.bfloat16, head_dtype=jhd)
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    jeng = JaxEngine(JaxMASt3R(jcfg), params, HW, int8_encoder=True,
                     int8_local_head=True)
    model = MASt3R(MASt3RConfig.tiny(dtype=torch.bfloat16, head_dtype=hd))
    model.load_state_dict(sd)
    eng = InferenceEngine(model, HW, device="cpu", int8_encoder=True,
                          int8_local_head=True)
    _assert_trees_equal(eng.qparams, quant_params_from_jax(jeng.qparams))
    _assert_trees_equal(eng.qlocal, quant_params_from_jax(jeng.qlocal))
    f32 = MASt3R(MASt3RConfig.tiny())
    f32.load_state_dict(sd)
    uncast = tq.quantize_encoder_params(f32)["enc_block_0"]["qkv"]
    assert not torch.equal(uncast.bias, eng.qparams["enc_block_0"]["qkv"].bias)


@pytest.mark.cuda
def test_int8_matmul_on_the_card_matches_the_cpu():
    """The card's int8 product (cuBLASLt through ``torch._int_mm``) gives
    the CPU's int32 accumulators bitwise, and a shape it does not take
    raises instead of going another way."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the int8 product runs on it")
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.integers(-127, 128, (1024, 4096)).astype(
        np.int8))
    x8 = torch.from_numpy(rng.integers(-127, 128, (768, 1024)).astype(
        np.int8))
    acc = tq.int_mm(x8.cuda(), w.cuda()).cpu()
    assert torch.equal(acc, torch._int_mm(x8, w))
    with pytest.raises(ValueError, match="16 rows"):
        tq.int_mm(x8[:16].cuda(), w.cuda())


# ---------------------------------------------------------------------------
# The slice as a whole: the 6-frame clip with the int8 encoder on both sides
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_runs():
    """``test_torch_frontend.py``'s clip and reference-exact configuration
    (the matcher whose own-matcher pose figure is 3e-3, poses held on every
    frame): the JAX ``SLAMSystem`` and the port's, each engine with
    ``int8_encoder=True``; then the port again with JAX's int8 encoder
    features (recorded frame by frame) in place of its own."""
    cfg = merge_config(load_config("config/base.yaml"),
                       {"matching": REFERENCE_EXACT_OVERRIDES["matching"],
                        "local_opt": REFERENCE_EXACT_OVERRIDES["local_opt"]})
    sd, params, frames = _clip_inputs()
    feats = []
    with pytest.MonkeyPatch.context() as mp:
        encode = JaxEngine.encode

        def record(self, img):
            out = encode(self, img)
            feats.append(tuple(np.array(t) for t in out))
            return out

        mp.setattr(JaxEngine, "encode", record)
        jax_run = _run_jax(params, cfg, frames, int8_encoder=True)
    port_run = _run_port(sd, cfg, frames, int8_encoder=True)
    given = iter(feats)
    with pytest.MonkeyPatch.context() as mp:
        def shared(self, img):
            assert self.qparams is not None
            return tuple(torch.from_numpy(t) for t in next(given))

        mp.setattr(InferenceEngine, "encode", shared)
        shared_run = _run_port(sd, cfg, frames, int8_encoder=True)
    return jax_run, port_run, shared_run


def test_int8_clip_tracks_and_decides_like_jax(int8_runs):
    (jlog, jkf, jsys), (tlog, tkf, tsys), _ = int8_runs
    assert jsys.engine.qparams is not None
    assert tsys.engine.qparams is not None
    assert len(tlog) == len(jlog) == len(_clip_inputs()[2])
    assert all(s["mode"] == "TRACKING" for s in tlog[1:])
    assert any(s["new_kf"] for s in tlog[1:])
    assert [s["mode"] for s in tlog] == [s["mode"] for s in jlog]
    assert [s["new_kf"] for s in tlog] == [s["new_kf"] for s in jlog]
    assert tkf.shape == jkf.shape
    assert tsys.stats == jsys.stats
    assert tsys.graph.n_edges == jsys.graph.n_edges


@pytest.mark.parametrize("run,atol", [(1, CLIP_POSE_ATOL),
                                      (2, SHARED_FEAT_POSE_ATOL)],
                         ids=["own_features", "jax_features"])
def test_int8_clip_poses_match_jax(int8_runs, run, atol):
    (jlog, jkf, _), (tlog, tkf, _) = int8_runs[0], int8_runs[run]
    assert [s["new_kf"] for s in tlog] == [s["new_kf"] for s in jlog]
    diffs = [np.abs(ts["T_WC"] - js["T_WC"]).max()
             for js, ts in zip(jlog, tlog)]
    print(f"int8 clip, port ({'own' if run == 1 else 'JAX'} features) "
          f"against JAX, per-frame pose difference: "
          f"{[f'{d:.2e}' for d in diffs]}; keyframes "
          f"{np.abs(tkf - jkf).max():.2e}")
    assert max(diffs) <= atol
    np.testing.assert_allclose(tkf, jkf, atol=atol, rtol=0)
