"""The VGGT-1B configuration (``configs/vggt-1b-bf16.json``,
``arch/vggt.py``): a tiny copy of its cell through the harness on the CPU,
the control failing it, its operation count, its reference's strict load,
and the readers of its spans."""

import importlib
import json
import time
import types

import pytest
import torch

from benchmark import harness, vggt_flops, vggt_weights
from benchmark.reference import vggt as ref_vggt
from benchmark.tests import _tiny
from benchmark.tests.test_benchmark_faults import _pose_unchanged
from benchmark.tests.test_benchmark_program_spans import (_frame,
                                                          _program_run,
                                                          _records)

CELL = "vggt1b-bf16.solo-still"
CONFIG = "vggt-1b-bf16"
NAMES = {"net_config", "make_state_dict", "build_program", "reference",
         "model_step", "ATTENTION_MODULES", "tiny"}
# the tiny cell computes in float32 on both sides: the network's gap is
# rounding (~1e-6); the first tracked frame's pose misses under 0.01% of
# the reference's move (a pose left unchanged misses all of it); the
# control (fp8 products) reads net_gap 0.14-0.17 and misses the move
# 2-11 times over
TINY_LIMITS = {"limits": {"net_gap": {"limit": 1e-5},
                          "kf_decisions": {"limit": 0},
                          "start_pose_miss": {"limit": 0.1}}}


def _config():
    return json.loads((harness.BENCH / "configs" / f"{CONFIG}.json")
                      .read_text())


@pytest.fixture
def tiny(monkeypatch):
    """The tiny copy of the VGGT cell, made as ``_tiny.tiny_cell`` makes
    the committed cells'."""
    monkeypatch.setitem(_tiny.CELLS, CELL, (CONFIG, "solo-still"))
    torch.set_num_threads(2)
    return _tiny.tiny_cell(CELL, TINY_LIMITS)


def test_the_manifest_names_the_cell_and_its_file():
    m = harness.load_manifest()
    cell = harness.load_cell(CELL)
    assert cell.config["architecture"] == "vggt"
    assert cell.workload["chips"] == 1
    assert {c["name"]: c["file"] for c in m["configs"]}[CONFIG] == \
        f"benchmark/configs/{CONFIG}.json"
    for name in ("aggregate_ms_p50", "vggt_heads_ms_p50"):
        (e,) = [e for e in m["per_layer"] if e["name"] == name]
        assert e["workloads"] == [CELL] and e["moves"] == "fps"


def test_the_vggt_file_defines_the_seven_names():
    mod = harness.load_arch({"architecture": "vggt"})
    public = {k for k, v in vars(mod).items()
              if not k.startswith("_") and k != "annotations"
              and not isinstance(v, types.ModuleType)}
    assert public == NAMES


def test_a_tiny_cell_runs_through_the_harness(tiny, monkeypatch):
    """Traced, with the program's tracer read as the traced run on the
    card reads it: correct, no frame failed, kernel A counted where
    ``ATTENTION_MODULES`` says, and the two new readers find their
    spans."""
    from mast3r_slam_torch.utils.profiler import TRACER

    runs = []
    run_data = harness.RunData

    def captured(*a, **kw):
        runs.append(run_data(*a, **kw))
        return runs[-1]
    monkeypatch.setattr(harness, "RunData", captured)
    mod = importlib.import_module("mast3r_slam_torch.models.vggt")
    attention = mod.flash_attention
    TRACER.reset()
    TRACER.enable()
    try:
        out = harness.run_cell(tiny, 2 ** 31 + 177, 3.0, True, "cpu",
                               time.perf_counter(), log=lambda m: None)
    finally:
        TRACER.disable()
    assert mod.flash_attention is attention
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 3
    (run,) = runs
    # per tracked frame: 2 encoder blocks, 4 frame and 4 global blocks
    # (B, H, Nq, Nk, Dh): the encoder's 1 + 4 + 20 tokens, the frame
    # blocks' two views of 5 + 20, the global blocks' 50
    assert {s for _, s in run.attn} == {(1, 2, 25, 25, 32),
                                        (2, 2, 25, 25, 32),
                                        (1, 2, 50, 50, 32)}
    run.program_spans = TRACER.records()
    TRACER.reset()
    agg = harness.read_metric("aggregate_ms_p50", run)
    heads = harness.read_metric("vggt_heads_ms_p50", run)
    dec = harness.read_metric("decode_ms_p50", run)
    assert 0 < agg < dec and 0 < heads < dec
    # medians do not add: each VGGT span is held inside its decode instead
    rec = run.program_spans
    for name, _, _, parent, t0, t1, _, _ in rec:
        if name.startswith("vggt."):
            up = rec[parent]
            assert up[0] == "inference.decode" and up[4] <= t0 <= t1 <= up[5]
    # the MASt3R cells' per-layer metrics read as before
    assert harness.read_metric("track_ms_p50", run) is not None


def test_the_control_fails_a_limit_of_the_tiny_cell(tiny):
    out = harness.run_cell(tiny, 2 ** 31 + 5, 2.0, False, "cpu",
                           time.perf_counter(), log=lambda m: None,
                           control=True)
    assert out["correct"], out["checks"]
    ok, rows = harness.judge(tiny, out["control"])
    assert not ok, rows
    assert out["control"]["net_gap"] > 1e3 * out["program"]["net_gap"]


def test_a_pose_left_unchanged_fails_the_cell(tiny, monkeypatch):
    """A tracking step that returns the frame's pose unchanged misses all
    of the reference's move on the first tracked frame (it reads 1): the
    tiny cell fails it, and so does the committed cell's limit."""
    _pose_unchanged(monkeypatch)
    out = harness.run_cell(tiny, 2 ** 31 + 9, 2.0, False, "cpu",
                           time.perf_counter(), log=lambda m: None)
    checks = out["checks"]
    assert out["correct"] is False, checks
    assert checks["start_pose_miss"]["value"] == pytest.approx(1.0)
    assert checks["net_gap"]["value"] <= checks["net_gap"]["limit"]
    lim = harness.load_cell(CELL).limits["limits"]["start_pose_miss"]
    assert lim["lower"] < lim["limit"] < 1.0


def test_the_weights_make_the_special_tokens_attention_sinks():
    """In every aggregator block each special token's key, before the
    per-head LayerNorm, is the lowest RoPE frequency of both halves of
    each head, and every query leans to it; the LayerScale values are the
    conditioning's."""
    c = ref_vggt.VGGTNet(**harness.load_arch(_config()).tiny(
        _config())["network"] | {"dpt_layers": (0, 1, 2, 3),
                                 "dpt_channels": (16, 24, 32, 48)})
    sd = vggt_weights.make_state_dict(c, 3, "cpu", dtype=torch.float32)
    C, Dh = c.embed_dim, c.embed_dim // c.num_heads
    toks = torch.cat([sd["aggregator.camera_token"].reshape(-1, C),
                      sd["aggregator.register_token"].reshape(-1, C)])
    assert toks.shape == (10, C)
    assert torch.allclose(toks.pow(2).mean(-1).sqrt(),
                          torch.full((10,), 10.0))
    z = torch.nn.functional.layer_norm(toks, (C,), eps=1e-5)
    e = torch.zeros(Dh)
    e[Dh // 4 - 1] = e[Dh // 2 + Dh // 4 - 1] = 1.0
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(c.depth):
            b = f"aggregator.{kind}.{i}"
            k = z @ sd[f"{b}.attn.qkv.weight"][C:2 * C].T + \
                sd[f"{b}.attn.qkv.bias"][C:2 * C]
            assert torch.allclose(k, e.repeat(c.num_heads)[None]
                                  .expand(10, -1), atol=1e-4)
            assert torch.equal(sd[f"{b}.attn.q_norm.bias"], 5.0 * e)
            assert bool((sd[f"{b}.ls1.gamma"] == 0.5).all())
    assert bool((sd["aggregator.patch_embed.blocks.0.ls2.gamma"]
                 == 0.02).all())


def test_the_operation_count_from_the_shapes():
    """4.5 TFLOP a tracked frame at 392 x 518: the encode 0.74, the
    aggregator's Linears 2.51 and attention 0.64, the heads 0.63."""
    cfg = _config()
    net, hw = cfg["network"], cfg["img_hw"]
    step = harness.load_arch(cfg).model_step(cfg)
    assert set(step) == {"bf16"}
    lin, att = vggt_flops.aggregate(net, hw)
    heads = 2 * (vggt_flops.dpt_head(net, hw, 256, True)
                 + vggt_flops.dpt_head(net, hw, 128, False))
    assert vggt_flops.encode(net, hw) / 1e12 == pytest.approx(0.74, abs=5e-3)
    assert lin / 1e12 == pytest.approx(2.51, abs=1e-2)
    assert att / 1e12 == pytest.approx(0.64, abs=5e-3)
    assert heads / 1e12 == pytest.approx(0.63, abs=5e-3)
    assert step["bf16"] == pytest.approx(
        vggt_flops.encode(net, hw) + lin + att + heads, rel=1e-12)
    assert step["bf16"] / 1e12 == pytest.approx(4.52, abs=2e-2)


def test_the_reference_loads_the_seeded_weights_strictly():
    cfg = harness.load_arch(_config()).tiny(_config())
    arch = harness.load_arch(cfg)
    sd = arch.make_state_dict(cfg, "cpu")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    net = arch.reference(cfg, sd, harness.precision(cfg, "reference"),
                         "cpu")
    assert set(net.state_dict()) == set(sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        ref_vggt.build(arch.net_config(cfg),
                       {k: v for k, v in sd.items()
                        if k != "point_head.norm.weight"},
                       harness.precision(cfg, "reference"), "cpu")
    # the same draw makes the program's weights: its state dict loads
    engine = arch.build_program(cfg, sd, "cpu")
    assert set(engine.model.state_dict()) == set(sd)


def test_the_readers_of_the_vggt_spans():
    rec = _records(
        _frame(0, 0.0, 0.1, [("inference.decode", 0.01, 0.09),
                             ("vggt.aggregate", 0.01, 0.05, 1),
                             ("vggt.point_head", 0.05, 0.07, 1)],
               note="INIT"),
        _frame(1, 0.1, 0.2, [("tracker.step", 0.11, 0.19),
                             ("inference.decode", 0.11, 0.18, 1),
                             ("vggt.aggregate", 0.11, 0.15, 2),
                             ("vggt.point_head", 0.15, 0.16, 2),
                             ("vggt.track_head", 0.16, 0.175, 2)]),
        _frame(2, 0.2, 0.3, [("tracker.step", 0.21, 0.29),
                             ("inference.decode", 0.21, 0.28, 1),
                             ("vggt.aggregate", 0.21, 0.23, 2),
                             ("vggt.point_head", 0.23, 0.235, 2),
                             ("vggt.track_head", 0.235, 0.24, 2)]))
    run = _program_run(rec, [100.0] * 3)
    assert harness.read_metric("aggregate_ms_p50", run) == \
        pytest.approx(30.0)
    # frame 1: 10 + 15 ms, frame 2: 5 + 5 ms
    assert harness.read_metric("vggt_heads_ms_p50", run) == \
        pytest.approx(17.5)
    # a MASt3R run has neither span
    mast3r = _records(_frame(1, 0.1, 0.2, [("inference.decode", 0.11, 0.18)]))
    run = _program_run(mast3r, [100.0] * 2)
    assert harness.read_metric("aggregate_ms_p50", run) is None
    assert harness.read_metric("vggt_heads_ms_p50", run) is None
