"""The port's tracer (``utils.profiler.TRACER``) on the frame path.

A ``SLAMSystem`` over the tiny seeded network on the CPU, with
``config/base.yaml``'s threaded backend, drives six frames of a panning
clip (INIT, tracked frames, two keyframes and their backend rounds) with
the tracer on; the spans must nest, carry their frame's or keyframe's key
and sit on their thread.  Off, the tracer records nothing and reads no
clock.  The file imports nothing of JAX, so that it also runs on the
card's machine::

    python -m pytest tests/test_torch_tracing.py -q --noconftest

where the ``cuda``-marked test checks the card's one host read of the GN
solve.
"""

import time

import pytest
import torch

from mast3r_slam_torch.models.mast3r import MASt3RConfig
from mast3r_slam_torch.ops.matching import MatchingConfig
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.testing import build_seeded_engine, make_clip
from mast3r_slam_torch.utils.config import load_config
from mast3r_slam_torch.utils.profiler import TRACER

H, W = 64, 96
N_FRAMES = 6
# the documented spans; sync.gn_result is the card's (the CPU runs the
# plain GN loop)
FRONTEND = ("pipeline.frame", "pipeline.prepare", "inference.encode",
            "tracker.step", "inference.decode", "matching.match",
            "tracker.gn", "frame.fuse", "sync.kf_decision")
BACKEND = ("pipeline.backend_round", "global_opt.add_factors",
           "global_opt.solve")


@pytest.fixture(autouse=True)
def _tracer_off():
    TRACER.disable()
    TRACER.reset()
    yield
    TRACER.disable()
    TRACER.reset()


def _system(device="cpu", single_thread=False, **net):
    cfg = load_config("config/base.yaml")
    cfg["single_thread"] = single_thread
    engine, _ = build_seeded_engine(
        MASt3RConfig.tiny(**net), (H, W), 0, device=device,
        match_cfg=MatchingConfig.from_dict(cfg["matching"]))
    return SLAMSystem(cfg, engine, (H, W), buffer=N_FRAMES, device=device)


@pytest.fixture(scope="module")
def drive():
    """(records, per-frame infos, the backend thread's id) of the traced
    drive, and one more frame driven with the tracer off."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = _system()
        frames = make_clip(0, N_FRAMES + 1, (H, W), shift=4)
        TRACER.reset()
        TRACER.enable()
        try:
            infos = [system.process_frame(i, img)
                     for i, img in enumerate(frames[:N_FRAMES])]
            system.drain()
        finally:
            TRACER.disable()
        backend = system._backend_thread.ident
        records = TRACER.records()
        system.process_frame(N_FRAMES, frames[N_FRAMES])
        after = TRACER.records()
        system.terminate()
    finally:
        torch.set_num_threads(n)
    return records, infos, backend, after


def test_the_drive_tracks_and_makes_keyframes(drive):
    _, infos, _, _ = drive
    assert infos[0]["mode"] == "INIT"
    assert all(i["mode"] == "TRACKING" for i in infos[1:])
    assert any(i["new_kf"] for i in infos)


@pytest.mark.parametrize("name", FRONTEND + BACKEND)
def test_every_documented_span_is_recorded(drive, name):
    records, _, _, _ = drive
    assert any(r[0] == name for r in records), name


def test_children_lie_inside_their_parent_on_its_thread_with_its_key(drive):
    records, _, _, _ = drive
    children = 0
    for name, key, thread, parent, t0, t1, cpu_s, _ in records:
        assert t0 <= t1 and cpu_s >= 0.0
        if parent is None:
            assert name in ("pipeline.frame", "pipeline.backend_round"), name
            continue
        children += 1
        p = records[parent]
        assert p[4] <= t0 and t1 <= p[5], (name, p[0])
        assert thread == p[2] and key == p[1], (name, p[0])
    assert children > 2 * N_FRAMES


def test_a_frame_span_is_keyed_by_its_index_and_noted_with_its_mode(drive):
    records, infos, _, _ = drive
    frames = [r for r in records if r[0] == "pipeline.frame"]
    assert [r[1] for r in frames] == list(range(N_FRAMES))
    assert [r[7] for r in frames] == [
        i["mode"] + ("+kf" if i["new_kf"] else "") for i in infos]
    # the frame's sections are its children, each tracked frame's host
    # reads beneath its tracker step
    for k, (_, key, _, _, _, _, _, note) in enumerate(frames):
        names = [r[0] for r in records if r[1] == key and r[3] is not None
                 and records[r[3]][0] == "pipeline.frame"]
        want = ["pipeline.prepare", "inference.encode", "pipeline.prepare"]
        want += ["inference.decode", "frame.fuse"] if note == "INIT" \
            else ["tracker.step"]
        assert names == want, (k, names)
    steps = [i for i, r in enumerate(records) if r[0] == "tracker.step"]
    for i in steps:
        kids = [r[0] for r in records if r[3] == i]
        assert kids == ["inference.decode", "matching.match", "frame.fuse",
                        "tracker.gn", "frame.fuse", "sync.kf_decision",
                        "sync.kf_decision"], kids


def test_backend_spans_sit_on_the_backend_thread_keyed_by_keyframe(drive):
    records, infos, backend, _ = drive
    rounds = [r for r in records if r[0] == "pipeline.backend_round"]
    # INIT's keyframe 0, then one round per new keyframe
    assert [r[1] for r in rounds] == list(
        range(1 + sum(i["new_kf"] for i in infos)))
    for name, key, thread, *_ in records:
        assert (thread == backend) == (name in BACKEND), name
    # the first keyframe's round has no edge to add
    assert sum(r[0] == "global_opt.add_factors" for r in records) == \
        len(rounds) - 1


def test_off_the_tracer_records_nothing(drive):
    records, _, _, after = drive
    assert after == records


def test_a_disabled_span_is_one_shared_object_and_reads_no_clock(
        monkeypatch):
    def no_clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    monkeypatch.setattr(time, "thread_time", no_clock)
    a = TRACER.span("pipeline.frame", key=3)
    b = TRACER.span("tracker.gn")
    assert a is b
    with a as span:
        span.note = "TRACKING"
    assert TRACER.records() == []


def test_a_disabled_span_costs_under_a_microsecond():
    """The thread's own CPU time, so that a worker descheduled by its
    neighbours does not count their time."""
    span = TRACER.span

    def loop(n=20000):
        t0 = time.thread_time()
        for _ in range(n):
            with span("tracker.gn"):
                pass
        return (time.thread_time() - t0) / n

    assert min(loop() for _ in range(7)) < 1e-6


def test_the_tracer_records_while_torch_profiler_does():
    """A ``torch.profiler`` session turns the spans on, so a device trace
    has them beside it; they stop with it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with TRACER.span("pipeline.frame", key=7):
            with TRACER.span("tracker.step"):
                pass
    with TRACER.span("pipeline.frame", key=8):
        pass
    assert [(r[0], r[1], r[3]) for r in TRACER.records()] == [
        ("pipeline.frame", 7, None), ("tracker.step", 7, 0)]


def test_reset_drops_the_records_and_the_summary_reads_them(capsys):
    TRACER.enable()
    for k in range(3):
        with TRACER.span("pipeline.frame", key=k):
            with TRACER.span("inference.encode"):
                pass
            with TRACER.span("inference.decode"):
                pass
    s = TRACER.summary()
    assert {k: v["count"] for k, v in s.items()} == {
        "pipeline.frame": 3, "inference.encode": 3, "inference.decode": 3}
    TRACER.print_summary()
    out = capsys.readouterr().out
    assert "network (inference.encode + inference.decode)" in out
    TRACER.reset()
    assert TRACER.records() == []
    TRACER.disable()
    TRACER.print_summary()
    assert "no spans recorded" in capsys.readouterr().out


@pytest.mark.cuda
def test_a_tracked_frame_on_the_card_records_the_gn_read():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the GN solve's host read is the "
                    "CUDA kernel's")
    # heads of 64, the width kernel A is built for
    system = _system("cuda", single_thread=True, enc_embed_dim=128,
                     dec_embed_dim=128)
    frames = make_clip(0, 2, (H, W), shift=4)
    TRACER.enable()
    infos = [system.process_frame(i, img) for i, img in enumerate(frames)]
    TRACER.disable()
    system.terminate()
    # the second frame is tracked: its GN solve ran, lost or not
    assert infos[0]["mode"] == "INIT"
    assert infos[1]["mode"].startswith("TRACKING")
    records = TRACER.records()
    reads = [r for r in records if r[0] == "sync.gn_result"]
    assert len(reads) == 1
    assert reads[0][1] == 1 and records[reads[0][3]][0] == "tracker.gn"
