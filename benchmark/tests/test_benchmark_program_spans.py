"""The readers of the program's own spans, and the idle gaps labelled by
them, against hand-made runs."""

import pytest

from benchmark import harness
from benchmark.tests.test_benchmark_arith import _frames, _run, _trace
from benchmark.tools import program_trace

FRONT, BACK = 100, 200      # the frontend's and the backend's thread ids


def _frame(key, t0, t1, kids, note="TRACKING", cpu=None, thread=FRONT):
    """A ``pipeline.frame`` record and its children, each (name, start,
    end[, parent offset]) with the parent the frame unless given."""
    out = [("pipeline.frame", key, thread, None, t0, t1,
            (t1 - t0) if cpu is None else cpu, note)]
    for name, s, e, *p in kids:
        out.append((name, key, thread, p[0] if p else 0, s, e, e - s, None))
    return out


def _records(*frames):
    """Records with their parent offsets made list indices."""
    rec = []
    for f in frames:
        base = len(rec)
        for r in f:
            rec.append(r[:3] + (None if r[3] is None else base + r[3],)
                       + r[4:])
    return rec


def _program_run(records, frames_ms, trace=None, seconds=2.0):
    run = _run(_frames(frames_ms), seconds=seconds, trace=trace)
    run.program_spans = records
    return run


def test_span_medians_count_only_window_frames_summed_per_key():
    # frames 0..2 complete in the window (100 ms each from 0); frame 9
    # never completed in it; the backend's round is on its own thread
    rec = _records(
        _frame(0, 0.0, 0.1, [("inference.decode", 0.01, 0.03),
                             ("frame.fuse", 0.05, 0.06)], note="INIT"),
        _frame(1, 0.1, 0.2, [("tracker.step", 0.11, 0.19),
                             ("inference.decode", 0.11, 0.15, 1),
                             ("matching.match", 0.15, 0.16, 1),
                             ("frame.fuse", 0.16, 0.162, 1),
                             ("tracker.gn", 0.163, 0.166, 1),
                             ("sync.gn_result", 0.164, 0.1655, 5),
                             ("frame.fuse", 0.17, 0.174, 1),
                             ("sync.kf_decision", 0.18, 0.181, 1),
                             ("sync.kf_decision", 0.182, 0.1825, 1)]),
        _frame(2, 0.2, 0.3, [("tracker.step", 0.21, 0.29),
                             ("inference.decode", 0.21, 0.27, 1),
                             ("matching.match", 0.27, 0.28, 1),
                             ("frame.fuse", 0.28, 0.281, 1),
                             ("tracker.gn", 0.281, 0.283, 1),
                             ("frame.fuse", 0.283, 0.284, 1),
                             ("sync.kf_decision", 0.285, 0.289, 1)],
               note="TRACKING+kf"),
        _frame(9, 1.9, 2.5, [("inference.decode", 1.9, 2.4)]),
        [("pipeline.backend_round", 1, BACK, None, 0.2, 0.25, 0.05, None),
         ("inference.decode", 1, BACK, 0, 0.2, 0.22, 0.02, None)])
    run = _program_run(rec, [100.0] * 3)
    read = harness.read_metric
    # the tracked frames 1 and 2 only: not INIT's decode, not frame 9's,
    # not the backend's
    assert read("decode_ms_p50", run) == pytest.approx(50.0)
    assert read("match_ms_p50", run) == pytest.approx(10.0)
    assert read("gn_ms_p50", run) == pytest.approx(2.5)
    assert read("fuse_ms_p50", run) == pytest.approx(0.5 * (6.0 + 2.0))
    # frame 1: 1.5 + 1.0 + 0.5 ms; frame 2: 4.0 ms
    assert read("host_sync_ms_p50", run) == pytest.approx(3.5)


def test_a_frame_outside_the_window_or_on_another_thread_is_not_read():
    rec = _records(
        _frame(0, -0.5, 0.1, [("tracker.step", -0.4, 0.0)]),
        _frame(1, 0.1, 0.2, [("tracker.step", 0.1, 0.2)], thread=FRONT + 1))
    run = _program_run(rec, [100.0] * 2)
    for m in ("decode_ms_p50", "frame_offcpu_ms_p50"):
        assert harness.read_metric(m, run) is None


@pytest.mark.parametrize("name", ["decode_ms_p50", "match_ms_p50",
                                  "gn_ms_p50", "fuse_ms_p50",
                                  "host_sync_ms_p50", "frame_offcpu_ms_p50",
                                  "kernels_per_frame"])
def test_a_run_without_program_spans_reads_nothing(name):
    # no spans handed over and no device trace (an untraced run), or a
    # traced run of a program without the tracer
    assert harness.read_metric(name, _run(_frames([100.0]))) is None
    run = _run(_frames([100.0]), trace=_trace([("k", 0.01, 0.02)]))
    run.program_spans = []
    assert harness.read_metric(name, run) is None


def test_off_cpu_time_is_wall_time_less_the_threads_cpu_time():
    rec = _records(_frame(0, 0.0, 0.1, [], cpu=0.09),
                   _frame(1, 0.1, 0.2, [], cpu=0.07),
                   _frame(2, 0.2, 0.3, [], cpu=0.1))
    run = _program_run(rec, [100.0] * 3)
    assert harness.read_metric("frame_offcpu_ms_p50", run) == \
        pytest.approx(10.0)


def test_kernels_are_counted_by_the_frame_span_they_start_in():
    rec = _records(_frame(0, 0.0, 0.1, []), _frame(1, 0.1, 0.2, []),
                   _frame(2, 0.25, 0.3, []))
    ops = [("k", 0.01, 0.02), ("k", 0.09, 0.15),     # frame 0
           ("k", 0.1, 0.11), ("k", 0.12, 0.13),      # frame 1
           ("k", 0.2, 0.3), ("k", 0.21, 0.22),       # between frames
           ("k", 0.26, 0.27),                        # frame 2
           ("k", -0.2, -0.1), ("k", 0.4, 0.5)]       # outside every frame
    run = _program_run(rec, [100.0] * 3, trace=_trace(ops))
    assert harness.read_metric("kernels_per_frame", run) == \
        pytest.approx(5 / 3)


def test_a_program_span_inside_a_wrapper_takes_the_gap():
    tr = _trace([("k", 0.2, 0.4), ("k", 0.6, 0.8)])
    run = _program_run(_records(
        _frame(0, 0.0, 0.9, [("tracker.step", 0.42, 0.58),
                             ("inference.decode", 0.43, 0.5, 1),
                             ("sync.kf_decision", 0.5, 0.57, 1)]),
        # entirely before the window's first gap midpoint: no gap of its own
        _frame(5, -1.0, -0.5, [("inference.decode", -0.9, -0.6)])),
        [900.0], trace=tr)
    wrappers = {FRONT: [("frame", 0.0, 1.0, 0),
                        ("tracker.track", 0.41, 0.59, 1)]}
    merged = program_trace.thread_spans(run, wrappers)
    gaps = dict(program_trace.idle_gaps(tr, merged))
    # gap midpoints: 0.1 (frame), 0.5 (tracker.step's sync read, which
    # starts at 0.5), 0.9 (after the program's frame: the wrapper)
    assert gaps == {"pipeline.frame": pytest.approx(0.2),
                    "sync.kf_decision": pytest.approx(0.2),
                    "frame": pytest.approx(0.2)}
    assert program_trace.wrapper_share(list(gaps.items())) == \
        pytest.approx(1 / 3)


def test_without_program_spans_the_labels_are_the_wrappers_as_before():
    tr = _trace([("k", 0.2, 0.4), ("k", 0.6, 0.8)])
    spans = {1: [("frame", 0.0, 1.0, 0), ("tracker.track", 0.45, 0.55, 1)],
             2: [("backend.round", 0.0, 0.3, 0)]}
    run = _run(_frames([100.0]), trace=tr)
    run.program_spans = []
    merged = program_trace.thread_spans(run, spans)
    assert program_trace.idle_gaps(tr, merged) == tr.idle_gaps(spans)


def test_nested_spans_of_one_name_label_by_their_depth():
    tr = _trace([("k", 0.2, 0.4)])
    spans = {1: [("a", 0.0, 1.0, 3), ("b", 0.05, 0.15, 4),
                 ("a", 0.06, 0.14, 5)]}
    gaps = dict(program_trace.idle_gaps(tr, spans))
    assert gaps == {"a": pytest.approx(0.8)}
    spans = {1: [("a", 0.0, 1.0, 3), ("b", 0.05, 0.15, 4)]}
    gaps = dict(program_trace.idle_gaps(tr, spans))
    assert gaps == {"b": pytest.approx(0.2), "a": pytest.approx(0.6)}


def test_the_span_table_gives_the_tracker_steps_cover():
    rec = _records(_frame(1, 0.0, 0.1, [("tracker.step", 0.0, 0.1),
                                        ("inference.decode", 0.0, 0.06, 1),
                                        ("matching.match", 0.06, 0.08, 1),
                                        ("sync.kf_decision", 0.08, 0.09,
                                         1)]))
    run = _program_run(rec, [100.0])
    run.frames = [(1,) + run.frames[0][1:]]
    t = program_trace.span_table(run)
    assert t["tracker.step"] == pytest.approx(100.0)
    assert t["tracker.step.self"] == pytest.approx(10.0)
    assert t["tracker.step.covered"] == pytest.approx(0.9)
    assert t["tracked_frames"] == 1


def test_the_tool_reads_the_spans_of_a_run_with_the_tracer_alone(
        monkeypatch):
    """A tiny cell's untraced run with the program's tracer on over the
    window: the frames' spans are read, each inside the harness's own
    clock of its frame, and the patched harness is restored."""
    import time

    import torch

    from benchmark.tests._tiny import TINY_LIMITS, tiny_cell

    torch.set_num_threads(2)
    runs = []
    run_data = harness.RunData

    def captured(*a, **kw):
        runs.append(run_data(*a, **kw))
        return runs[-1]
    monkeypatch.setattr(harness, "RunData", captured)
    before = (harness.spans_by_thread, harness.RunData)
    cell = tiny_cell("vitl512-int8.solo-still",
                     TINY_LIMITS["vitl512-int8.solo-still"])
    out = program_trace.run_cell(cell, 2 ** 31 + 91, 3.0, False, "cpu",
                                 time.perf_counter(), log=lambda m: None)
    assert (harness.spans_by_thread, harness.RunData) == before
    assert out["correct"], out["checks"]
    t = out["spans"]
    assert t["tracked_frames"] >= 2
    assert 0.9 <= t["tracker.step.covered"] <= 1.0
    assert t["pipeline.frame"] >= t["tracker.step"] > t["inference.decode"]
    m = out["metrics"]
    assert m["frame_offcpu_ms_p50"]["value"] >= 0.0
    # every completed frame's span lies inside the harness's clock around
    # its process_frame (the two medians are over different frames: the
    # harness's over all, the table's over the tracked ones)
    (run,) = runs
    span = {r[1]: r for r in run.program_spans
            if r[0] == "pipeline.frame" and r[2] == run.thread}
    for k, t0, t1, *_ in run.frames:
        assert t0 <= span[k][4] <= span[k][5] <= t1
    assert "markers" not in out
