"""The metrics' arithmetic against hand-worked cases."""

import pytest

from benchmark import flops, harness
from benchmark.metrics._spans import median_ms
from benchmark.trace import DeviceTrace


def _run(frames, seconds=2.0, spans=None, attn=None, trace=None,
         step_flops=None):
    return harness.RunData(seconds, (0.0, seconds), 7.5, frames,
                           len(frames), 0, spans, attn, trace,
                           step_flops or {"bf16": 0.0, "int8": 0.0}, 100)


def _frames(ms):
    out, t = [], 0.0
    for i, d in enumerate(ms):
        out.append((i, t, t + d / 1e3, "TRACKING", i % 4 == 0))
        t += d / 1e3
    return out


def test_rate_percentiles_share_and_setup():
    run = _run(_frames([10.0 * k for k in range(1, 21)]))
    assert harness.read_metric("fps", run) == pytest.approx(10.0)
    # 20 values 10..200: linear interpolation at 0.9 * 19 = 17.1
    assert harness.read_metric("frame_ms_p90", run) == pytest.approx(181.0)
    assert harness.read_metric("frame_ms_p50", run) == pytest.approx(105.0)
    assert harness.read_metric("kf_share", run) == pytest.approx(25.0)
    assert harness.read_metric("setup_s", run) == 7.5


def test_span_medians_count_only_the_window():
    spans = [("tracker.track", 1, 0.1, 0.13), ("tracker.track", 1, 0.2,
                                                0.25),
             ("tracker.track", 2, 0.3, 0.31), ("tracker.track", 2, 1.9, 2.5),
             ("engine.encode", 1, 0.0, 0.004)]
    run = _run(_frames([100.0]), spans=spans)
    assert harness.read_metric("track_ms_p50", run) == pytest.approx(30.0)
    assert harness.read_metric("encode_ms_p50", run) == pytest.approx(4.0)
    # a span the run never recorded reads nothing, not 0
    assert median_ms(run, "backend.round") is None


def _trace(ops, t0=0.0, t1=1.0):
    tr = DeviceTrace()
    tr.t0, tr.t1, tr.ops = t0, t1, ops
    return tr


def test_interval_union_and_idle_share():
    tr = _trace([("a", 0.1, 0.3), ("b", 0.2, 0.4), ("c", 0.5, 0.6),
                 ("d", 0.95, 1.2), ("e", -0.5, -0.1)])
    assert tr.busy_s() == pytest.approx(0.3 + 0.1 + 0.05)
    run = _run(_frames([100.0]), trace=tr)
    assert harness.read_metric("device_idle_share", run) == \
        pytest.approx(55.0)
    assert tr.top_ops(2) == [["b", pytest.approx(0.2)],
                             ["a", pytest.approx(0.2)]]


def test_idle_gaps_are_labelled_by_the_innermost_spans():
    tr = _trace([("k", 0.2, 0.4), ("k", 0.6, 0.8)])
    spans = {1: [("frame", 0.0, 1.0, 0), ("tracker.track", 0.45, 0.55, 1)],
             2: [("backend.round", 0.0, 0.3, 0)]}
    gaps = dict(tr.idle_gaps(spans))
    assert gaps == {"backend.round+frame": pytest.approx(0.2),
                    "tracker.track": pytest.approx(0.2),
                    "frame": pytest.approx(0.2)}


def test_attention_roofline_and_mfu():
    shape = (1, 16, 768, 768, 64)
    ops = flops.attention(*shape)
    assert ops == 4 * 16 * 768 * 768 * 64
    # two launches in the window, one outside; 1 ms of kernel time
    tr = _trace([("attn_fwd_bf16<x>", 0.1, 0.1005),
                 ("attn_fwd_bf16<x>", 0.2, 0.2005),
                 ("attn_fwd_bf16<x>", 1.5, 1.6)])
    run = _run(_frames([100.0] * 4), attn=[(0.1, shape), (0.2, shape),
                                           (1.5, shape)], trace=tr)
    want = 100.0 * 2 * ops / (flops.PEAK["bf16"] * 1e-3)
    assert harness.read_metric("attn_roofline", run) == pytest.approx(want)
    run = _run(_frames([100.0] * 4), seconds=2.0,
               step_flops={"bf16": 989e9, "int8": 1979e9})
    # each frame takes 2 ms at the peaks; 4 frames in 2 s
    assert harness.read_metric("frame_mfu", run) == pytest.approx(0.4)


def test_model_step_counts_a_hand_worked_tiny_network():
    net = dict(patch_size=2, enc_embed_dim=4, enc_depth=1, dec_embed_dim=2,
               dec_depth=1, mlp_ratio=1, local_feat_dim=1, feature_dim=2,
               last_dim=2, layer_dims=[2, 2, 2, 2])
    f = flops.model_step(net, (4, 8), int8_encoder=True)
    n = 8      # 2 x 4 tokens
    enc_lin = 2 * n * (4 * 12 + 4 * 4 + 2 * 4 * 4)
    assert f["int8"] == enc_lin
    enc_rest = 4 * n * n * 4 + 2 * n * 12 * 4
    dec = 2 * (2 * n * 4 * 2 + 2 * n * (2 * 6 + 2 * 2 + 4 * 2 * 2
                                        + 2 * 2 * 2) + 2 * 4 * n * n * 2)
    local = 2 * n * 6 * 24 + 2 * n * 24 * 8
    assert f["bf16"] == enc_rest + dec + 2 * (flops.dpt_head(net, (4, 8))
                                              + local)
