"""The traffic generator: the same work for every seed."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.clips import Clip

SEEDS = [0, 1, 7, 12345, 2 ** 31 + 11, 2 ** 32 + 5, 99, 3, 4, 5, 6, 2 ** 40]


def _traffic(name):
    return json.loads((harness.BENCH / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["solo-panhold", "solo-still"])
def test_schedule_and_frame_count_are_the_seeds_alike(name):
    tr = _traffic(name)
    tr["max_rate_fps"] = 2
    shapes, schedules, caps = set(), set(), set()
    for seed in SEEDS:
        c = Clip(tr, seed, (64, 96), 10.0)
        schedules.add(tuple(c.is_keyframe(t) for t in range(c.capacity)))
        caps.add(c.capacity)
        shapes.add(c.frame(c.capacity - 1).shape)
    assert len(schedules) == len(caps) == len(shapes) == 1
    sched = schedules.pop()
    K = tr["keyframe_every"]
    assert sched[0] and sum(sched) == (1 if not K else
                                       1 + (len(sched) - 1) // K)


def test_frames_come_from_the_seed():
    tr = _traffic("solo-panhold")
    tr["max_rate_fps"] = 2
    a = Clip(tr, 5, (64, 96), 4.0)
    b = Clip(tr, 5, (64, 96), 4.0)
    c = Clip(tr, 6, (64, 96), 4.0)
    assert np.array_equal(a.frame(9), b.frame(9))
    assert not np.array_equal(a.frame(9), c.frame(9))


@pytest.mark.parametrize("name", ["solo-panhold", "solo-still"])
def test_a_held_view_repeats_exactly(name):
    tr = _traffic(name)
    tr["max_rate_fps"] = 2
    c = Clip(tr, 2 ** 31 + 3, (64, 96), 8.0)
    K = tr["keyframe_every"] or c.capacity
    for t in range(1, min(K, c.capacity)):
        assert np.array_equal(c.frame(t), c.frame(0))


def test_a_jump_moves_the_view_by_the_jump():
    tr = _traffic("solo-panhold")
    tr["max_rate_fps"] = 2
    c = Clip(tr, 3, (64, 600), 4.0)
    J = tr["jump_px"]
    K = tr["keyframe_every"]
    assert np.array_equal(c.frame(0)[:, J:], c.frame(K)[:, :600 - J])


def test_a_camera_past_its_strip_fails_loudly():
    tr = _traffic("solo-still")
    tr["max_rate_fps"] = 1
    c = Clip(tr, 3, (64, 96), 1.0)
    with pytest.raises(RuntimeError, match="end of its strip"):
        c.frame(c.capacity)


@pytest.mark.parametrize("name", ["solo-panhold", "solo-still"])
def test_samples_come_from_the_seed_inside_their_range(name):
    tr = _traffic(name)
    chk = tr["check"]
    for seed in SEEDS:
        frames, ba_round = harness.samples(tr, seed)
        assert frames == harness.samples(tr, seed)[0]
        assert len(frames) == chk["tracked"]
        assert all(chk["frames"][0] <= t < chk["frames"][1] for t in frames)
        K = tr["keyframe_every"]
        assert sum(1 for t in frames if K and t % K == 0) == \
            chk.get("jumps", 0)
        if chk.get("ba_rounds"):
            assert chk["ba_rounds"][0] <= ba_round <= chk["ba_rounds"][1]
