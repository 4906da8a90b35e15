"""VGGT-1B on the port's frame path (``models/vggt.py``), held to the plain
float32 reference of the benchmark (``benchmark/reference/vggt.py``) at a
tiny size on the CPU, with seeded random weights made and conditioned by
``benchmark/vggt_weights.py``.

Tolerances: the port and the reference compute the same float32 function
by different routes (fused LayerNorm against the two-pass one, one affine
map for the input normalisation against two steps, linear layers as
matmuls against convolutions, an attention kernel's plain version against
blocked queries), so they differ by float32 rounding only: a relative RMS
gap of about 1e-6 on every output.  The limits below (``REL``, 2e-5) sit an
order above it and four orders below what a missing term moves (a dropped
LayerScale, RoPE or QK-norm, or a wrong camera token, moves the outputs
by 1e-2 or more).  The matcher works on int8 tables with exact integer
sums and is compared for equality.  The file imports nothing of JAX.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import vggt_weights
from benchmark.reference import matching as ref_matching
from benchmark.reference import vggt as ref_vggt
from benchmark.reference.network import Precision, reference_mode
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models import mast3r as mast3r_mod
from mast3r_slam_torch.models.rope import rope_2d
from mast3r_slam_torch.models.vggt import (VGGT, Block, VGGTConfig,
                                           apply_rope, rope_tables)
from mast3r_slam_torch.ops import matching
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config
from mast3r_slam_torch.utils.profiler import TRACER

H, W = 56, 70           # a 4 x 5 patch grid
# the benchmark's tiny size: width 64, 2 heads of 32, 2 encoder blocks,
# 4 aggregator depths read at (0, 1, 2, 3), narrow heads
TINY = dict(embed_dim=64, num_heads=2, enc_depth=2, depth=4, pos_grid=8,
            dpt_layers=(0, 1, 2, 3), dpt_channels=(16, 24, 32, 48),
            point_features=32, track_features=32, point_hidden=16)
REL = 2e-5


def rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b * b)))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    """(port model, reference, state dict) of the tiny network, f32."""
    sd = vggt_weights.make_state_dict(ref_vggt.VGGTNet(**TINY), 7, "cpu",
                                      dtype=torch.float32)
    model = VGGT(VGGTConfig(**TINY, dtype=torch.float32,
                            head_dtype=torch.float32))
    model.load_state_dict(sd, strict=True)
    ref = ref_vggt.build(ref_vggt.VGGTNet(**TINY), sd, Precision(), "cpu")
    return model.eval(), ref, sd


def _frames(seed, n=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _port_img(u8):
    """The frame path's input: [-1, 1], (1, h, w, 3)."""
    return torch.from_numpy(u8.astype(np.float32) * (1.0 / 127.5) - 1.0)[None]


def _ref_img(u8):
    mean = torch.tensor(ref_vggt.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(ref_vggt.STD).view(1, 3, 1, 1)
    x = torch.from_numpy(u8).permute(2, 0, 1)[None].float() / 255.0
    return (x - mean) / std


@pytest.mark.parametrize("kind", ["frame", "global"])
def test_an_aggregator_block_is_the_reference_block(net, kind):
    """One block with QK-norm, 2D RoPE and LayerScale (0.5, as the
    benchmark's weights have it, so that the branches weigh), on tokens of
    two views whose positions are their grids + 1 with the special tokens
    at 0."""
    model, ref, _ = net
    i = 1
    port = (model.aggregator.frame_blocks if kind == "frame"
            else model.aggregator.global_blocks)[i]
    rb = (ref.aggregator.frame_blocks if kind == "frame"
          else ref.aggregator.global_blocks)[i]
    port, rb = copy.deepcopy(port), copy.deepcopy(rb)
    for blk in (port, rb):
        with torch.no_grad():
            blk.ls1.gamma.fill_(0.5)
            blk.ls2.gamma.fill_(0.5)
    g = torch.Generator().manual_seed(3)
    P = 5 + 20
    x = torch.randn(2, P, 64, generator=g)
    yy, xx = torch.meshgrid(torch.arange(4), torch.arange(5), indexing="ij")
    grid = torch.stack([yy, xx], -1).reshape(20, 2) + 1
    pos = torch.cat([torch.zeros(5, 2, dtype=grid.dtype), grid])[None] \
        .expand(2, -1, -1)
    if kind == "global":
        x, pos = x.reshape(1, 2 * P, 64), pos.reshape(1, 2 * P, 2)
    with torch.no_grad(), reference_mode():
        out_p = port(x, rope_tables(pos, 32, 100.0))
        out_r = rb(x, pos)
        # the rotary and normalised q, k matter: without them it differs
        plain = Block(64, 2, 4, torch.float32, 1e-5, kind,
                      port.attn.launches)
        plain.load_state_dict({k: v for k, v in port.state_dict().items()
                               if "_norm" not in k})
        out_plain = plain(x)
    assert rel_rms(out_p - x, out_r - x) < REL
    assert rel_rms(out_plain - x, out_r - x) > 1e-2


@pytest.mark.parametrize("B,N", [(2, 25), (1, 50)], ids=["frame", "global"])
def test_the_rope_tables_turn_tokens_as_rope_2d(B, N):
    """The tables made once a forward turn q and k exactly as
    ``rope.rope_2d`` does, at a frame block's and a global block's
    positions."""
    g = torch.Generator().manual_seed(B)
    x = torch.randn(B, 2, N, 32, generator=g)
    pos = torch.randint(0, 40, (B, N, 2), generator=g)
    assert torch.equal(apply_rope(x, rope_tables(pos, 32, 100.0)),
                       rope_2d(x, pos, 100.0))


def test_the_dinov2_encode_resizes_its_table_to_a_grid_not_square(net):
    model, ref, _ = net
    u8 = _frames(11, 1)[0]
    with torch.no_grad(), reference_mode():
        feat, pos = model.encode(_port_img(u8))
        want = ref.aggregator.patch_embed(_ref_img(u8))
    assert feat.shape == (1, 20, 64) and feat.dtype == torch.float32
    assert torch.equal(pos[0, :6], torch.tensor(
        [[0, 0], [0, 1], [0, 2], [0, 3], [0, 4], [1, 0]]))
    assert rel_rms(feat, want) < REL
    # the table went from its 8 x 8 square to the 4 x 5 grid, once
    dino = model.aggregator.patch_embed
    (table,) = dino._pos_cache.values()
    assert table.shape == (1, 1 + 20, 64)
    assert not torch.equal(table[0, 1:6], dino.pos_embed[0, 1:6])


@pytest.mark.parametrize("head", ["point", "track"])
def test_a_dpt_head_at_an_odd_grid(net, head):
    """The heads on a 3 x 5 grid (42 x 70): the stride-2 level is 2 x 3,
    so every fusion resizes to the next level's size, not by 2."""
    model, ref, _ = net
    g = torch.Generator().manual_seed(5)
    toks = [torch.randn(2, 15, 128, generator=g) for _ in range(4)]
    with torch.no_grad(), reference_mode():
        if head == "point":
            got = model.point_head(toks, (42, 70))
            want = ref.point_head(toks, 42, 70)
        else:
            got = model.track_head.feature_extractor(toks, (42, 70))
            want = ref.track_head.feature_extractor(toks, 42, 70)
    assert got.shape == want.shape == (2, 4 if head == "point" else 32, 42,
                                       70)
    assert rel_rms(got, want) < REL


def _engine(model, **kw):
    cfg = load_config("config/base.yaml")
    return InferenceEngine(
        model, (H, W), match_cfg=matching.MatchingConfig.from_dict(
            cfg["matching"]), device="cpu", **kw)


def test_decode_pair_gives_the_reference_views(net):
    """The 8 outputs of ``encode`` x 2 then ``decode_pair`` (view 1 the
    frame), and kernel A's launches by kind per call."""
    model, ref, _ = net
    eng = _engine(model)
    a, b = _frames(21)
    with torch.no_grad():
        before = dict(model.launches)
        f1, p1 = eng.encode(_port_img(a))
        after_enc = dict(model.launches)
        f2, p2 = eng.encode(_port_img(b))
        views = eng.decode_pair(f1, p1, f2, p2)
        after = dict(model.launches)
    with reference_mode():
        want = ref.views(a, b)
    for v, w in zip(views, want):
        for got, exp in zip(v, w):
            assert got.shape == exp.shape
            assert rel_rms(got, exp) < REL
    # unit descriptors; the descriptor confidence is the point confidence
    assert torch.allclose(views[0][2].norm(dim=-1), torch.ones(1, H, W),
                          atol=1e-5)
    assert torch.equal(views[1][3], views[1][1])

    def delta(x, y):
        return {k: y.get(k, 0) - x.get(k, 0)
                for k in ("encoder", "frame", "global")}
    assert delta(before, after_enc) == {"encoder": 2, "frame": 0,
                                        "global": 0}
    assert delta(after_enc, after) == {"encoder": 2, "frame": 4,
                                       "global": 4}


def test_inference_mono_is_the_reference_frame_alone(net):
    """The keyframe's own pointmap: the frame alone (S = 1, one frame and
    one global block a depth), the point head only; it is not view 1 of
    the frame paired with itself, whose global blocks also read the
    second view's special tokens."""
    model, ref, _ = net
    eng = _engine(model)
    u8 = _frames(41, 1)[0]
    with torch.no_grad():
        f, p = eng.encode(_port_img(u8))
        before = dict(model.launches)
        X, C = eng.inference_mono(f, p)
        after = dict(model.launches)
        pair = eng.decode_pair(f, p, f, p)[0]
    with reference_mode():
        want = ref.view(u8)
    assert X.shape == (1, H * W, 3) and C.shape == (1, H * W, 1)
    assert rel_rms(X, want[0].reshape(1, -1, 3)) < REL
    assert rel_rms(C, want[1].reshape(1, -1, 1)) < REL
    assert rel_rms(X, pair[0].reshape(1, -1, 3)) > 1e-4
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("encoder", "frame", "global")} == \
        {"encoder": 0, "frame": 4, "global": 4}


def test_the_engine_serves_vggt_without_mast3r_only_paths(net):
    model = copy.deepcopy(net[0])
    for kw in (dict(int8_encoder=True), dict(int8_local_head=True)):
        with pytest.raises(ValueError, match="MASt3R"):
            _engine(model, **kw)
    eng = _engine(model)
    assert (eng.n_patches, eng.feat_dim) == (20, 64)


def test_the_decode_spans_sit_under_inference_decode(net):
    model = net[0]
    eng = _engine(model)
    f, p = eng.encode(_port_img(_frames(4, 1)[0]))
    TRACER.reset()
    TRACER.enable()
    try:
        eng.decode_pair(f, p, f, p)
    finally:
        TRACER.disable()
    rec = TRACER.records()
    TRACER.reset()
    names = [r[0] for r in rec]
    assert names == ["inference.decode", "vggt.aggregate", "vggt.point_head",
                     "vggt.track_head"]
    assert all(r[3] == 0 for r in rec[1:])
    TRACER.enable()
    try:
        eng.inference_mono(f, p)
    finally:
        TRACER.disable()
    rec = TRACER.records()
    TRACER.reset()
    assert [r[0] for r in rec] == ["inference.decode", "vggt.aggregate",
                                   "vggt.point_head"]


def _match_inputs(seed, b=1, h=24, w=32, f=128):
    """A smooth pointmap and a second view of it shifted by up to two
    pixels with noise, unit descriptors of width ``f`` following the
    points."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, h), torch.linspace(-1, 1, w),
                            indexing="ij")
    X = torch.stack([xx, yy, 2 + 0.2 * torch.sin(3 * xx) * torch.cos(2 * yy)],
                    -1)[None].expand(b, -1, -1, -1).contiguous()
    X2 = torch.roll(X, shifts=(1, 2), dims=(1, 2)) + \
        0.002 * torch.randn(X.shape, generator=g)
    D = torch.randn(b, h, w, f, generator=g)
    D = D / D.norm(dim=-1, keepdim=True)
    D2 = torch.roll(D, shifts=(1, 2), dims=(1, 2)) + \
        0.05 * torch.randn(D.shape, generator=g)
    D2 = D2 / D2.norm(dim=-1, keepdim=True)
    return X, X2, D, D2


@pytest.mark.parametrize("seed", [0, 1])
def test_the_matcher_at_128_features_is_the_plain_matcher(seed):
    """``match`` at F = 128 on int8 tables made with ``desc_prenorm`` (the
    engine's ``_q8_pair``) against the benchmark's plain matcher (one probe
    at a time, no packed table), with the production schedule; and the
    packed window argmax against its probe-by-probe statement."""
    cfg_d = load_config("config/base.yaml")["matching"]
    mcfg = matching.MatchingConfig.from_dict(cfg_d)
    X, X2, D, D2 = _match_inputs(seed)
    b, h, w, f = D.shape
    D8, D28 = matching._q8_pair(D, D2.reshape(b, -1, f), mcfg.desc_prenorm)
    assert D8.dtype == torch.int8 and D8.shape[-1] == 128
    assert int(D8.abs().max()) <= 127
    idx, valid = matching.match(X, X2, D8, D28.reshape(D2.shape), cfg=mcfg)
    ridx, rvalid = ref_matching.match(
        X, X2, ref_matching.q8(D), ref_matching.q8(D2),
        None, ref_matching.MatchCfg.from_dict(cfg_d))
    assert torch.equal(idx, ridx.reshape(idx.shape))
    assert torch.equal(valid, rvalid.reshape(valid.shape))
    # not the identity: the walk moved the queries
    assert bool(valid.any()) and bool((idx[0] != torch.arange(h * w)).any())
    g = torch.Generator().manual_seed(seed + 10)
    p1 = torch.stack([torch.randint(0, w, (1, 50), generator=g),
                      torch.randint(0, h, (1, 50), generator=g)], -1)
    q = D28[:, :50]
    for r, dmax in ((3, 4), (1, 1)):
        assert torch.equal(
            matching.refine_matches(D8, q, p1, radius=r, dilation_max=dmax),
            matching.refine_matches_probes(D8, q, p1, radius=r,
                                           dilation_max=dmax))


def test_match_desc_global_where_four_does_not_divide_the_width():
    """The retrieval edge's decode-free match at VGGT's aspect (a width of
    2 mod 4): half-grid outputs, and a view matched with itself maps each
    half-grid query to its own pixel."""
    cfg = matching.MatchingConfig()
    _, _, D, _ = _match_inputs(2, h=20, w=30, f=128)
    D8 = matching._q8_pair(D, D.reshape(1, -1, 128))[0]
    q = torch.full((1, 600, 1), 2.0)
    out = matching.match_desc_global(D8, D8, q, q, 20, 30, cfg)
    idx_ij, idx_ji, vm_j, vm_i = out[:4]
    assert idx_ij.shape == (1, 150) and vm_j.shape == (1, 150, 1)
    qi = torch.arange(150)
    own = (qi // 15) * 2 * 30 + (qi % 15) * 2
    assert torch.equal(idx_ij[0], own) and torch.equal(idx_ji[0], own)
    assert bool(vm_j.all()) and bool(vm_i.all())


def test_a_tiny_drive_makes_a_keyframe_through_the_symmetric_decode(net):
    """``SLAMSystem`` on the tiny VGGT: the first frame, a tracked frame
    that becomes a keyframe (the keyframe threshold above any metric), and
    its backend round inline, whose consecutive edge goes through the
    symmetric decode (``reuse_track_matches`` off, edges by decode): one
    B = 2 decode whose views are the single-pair decodes of (0, 1) and
    (1, 0)."""
    model = copy.deepcopy(net[0])
    cfg = load_config("config/base.yaml")
    cfg["single_thread"] = True
    cfg["tracking"]["match_frac_thresh"] = 1.01
    cfg["local_opt"]["reuse_track_matches"] = False
    cfg["local_opt"]["retrieval_edge_mode"] = "sym"
    eng = _engine(model)
    calls = []
    decode = eng.decode_pair

    def spy(*a):
        out = decode(*a)
        calls.append((a, out))
        return out
    eng.decode_pair = spy
    system = SLAMSystem(cfg, eng, (H, W), buffer=4, device="cpu")
    a = _frames(31, 1)[0]
    b = np.roll(a, 2, axis=1)
    infos = [system.process_frame(0, a), system.process_frame(1, b)]
    system.terminate()
    assert [i["mode"] for i in infos] == ["INIT", "TRACKING"]
    assert infos[1]["new_kf"] and system.graph.n_edges == 1
    (args, sym), = [c for c in calls if c[0][0].shape[0] == 2]
    f1, p1, f2, p2 = args
    for e in range(2):          # the edge's (0, 1), then its (1, 0)
        single = decode(f1[e:e + 1], p1[e:e + 1], f2[e:e + 1], p2[e:e + 1])
        for v in range(2):
            for k in range(4):
                assert rel_rms(sym[v][k][e:e + 1], single[v][k]) < REL
    with reference_mode():
        want = net[1].views(a, b)
    # view 1 of the pair (frame 0, frame 1) is the first batch row
    for got, exp in zip(sym[0], want[0]):
        assert rel_rms(got[0:1], exp) < REL


def _fusion_parent(block, x, skip=None):
    """``FeatureFusionBlock.forward`` as MASt3R's path had it before the
    block took a target size: a frozen copy."""
    def rcu(u, t):
        return t + u.conv2(torch.relu(u.conv1(torch.relu(t))))
    if skip is not None:
        x = x + rcu(block.resConfUnit1, skip)
    x = rcu(block.resConfUnit2, x)
    x = mast3r_mod.bilinear_resize_align_corners(x, 2 * x.shape[2],
                                                 2 * x.shape[3])
    return block.out_conv(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_skip", [False, True])
def test_the_shared_fusion_block_keeps_mast3r_bits(dtype, with_skip):
    """The DPT fusion block MASt3R shares with VGGT: with no size, and
    with the size equal to twice the input's, it gives the parent's
    output bit for bit."""
    torch.manual_seed(0)
    block = mast3r_mod.FeatureFusionBlock(16, dtype)
    if dtype == torch.bfloat16:
        block.to(dtype)
    x = torch.randn(1, 16, 5, 7).to(dtype)
    skip = torch.randn(1, 16, 5, 7).to(dtype) if with_skip else None
    with torch.no_grad():
        want = _fusion_parent(block, x, skip)
        assert torch.equal(block(x, skip), want)
        assert torch.equal(block(x, skip, size=(10, 14)), want)
