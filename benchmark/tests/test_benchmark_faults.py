"""The check fails what it must: a whole run on the CPU (the card's look
skipped) at the tiny size, clean and with the timed path broken
underneath, and the control, the reference one precision step down in the
program's place."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests._tiny import TINY_LIMITS, tiny_cell


def _run(monkeypatch=None, fault=None, workload="vitl512-bf16.solo-panhold",
         control=False):
    torch.set_num_threads(2)
    cell = tiny_cell(workload, TINY_LIMITS[workload])
    if fault is not None:
        fault(monkeypatch)
    return harness.run_cell(cell, 2 ** 31 + 77, 4.0, False, "cpu",
                            time.perf_counter(), log=lambda m: None,
                            control=control)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_small_traced_run_on_the_card_is_correct(card, monkeypatch):
    """The kernels, the backend thread and the device trace at a small size
    (heads of 64, the only width kernel A is built for): correct, and the
    trace finds the card busy."""
    torch.set_num_threads(1)
    # the network's outputs and the BA held to the reference; not the
    # keyframe decisions: this random network's keyframe metric sits near
    # the threshold, where the card's rounding flips one (a committed
    # cell's network keeps its held and jump frames 0.1 away from it)
    cell = tiny_cell(limits={"limits": {"net_gap": {"limit": 1e-5},
                                        "ba_gap": {"limit": 1e-3}}})
    cell.config["network"].update(enc_embed_dim=128, dec_embed_dim=128)
    out = harness.run_cell(cell, 2 ** 31 + 78, 4.0, True, "cuda",
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]


def test_the_command_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    res = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "vitl512-int8.solo-still", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


@pytest.mark.parametrize("workload", ["vitl512-bf16.solo-panhold",
                                      "vitl512-int8.solo-still"])
def test_a_clean_run_is_correct_and_the_control_is_not(workload):
    out = _run(workload=workload, control=True)
    assert out["correct"], out["checks"]
    ctl = out["control"]
    print(workload, "program", out["program"], "control", ctl)
    failed = [k for k, lim in TINY_LIMITS[workload]["limits"].items()
              if k in ctl and ctl[k] > lim["limit"]]
    assert failed, ctl


def _pointmap_altered(mp):
    """The network's answer altered where it is produced: one pixel of the
    frame's pointmap moved."""
    from mast3r_slam_torch import inference

    decode = inference.InferenceEngine.decode_pair

    def altered(self, *a):
        (X, C, D, Q), v2 = decode(self, *a)
        X = X.clone()
        X[:, 0, 0] += 1.0
        return (X, C, D, Q), v2
    mp.setattr(inference.InferenceEngine, "decode_pair", altered)


def _ba_unchanged(mp):
    """A backend round that returns the keyframes' poses unchanged."""
    from mast3r_slam_torch import global_opt

    solve = global_opt.FactorGraph.solve_poses

    def stuck(self, arena, residual_type):
        res = solve(self, arena, residual_type)
        if res is None:
            return res
        upd, T, stats = res
        T = T.clone()
        for c, r in enumerate(upd):
            if r < arena.n_size:
                T[c] = arena.T_WC[int(r)]
        return upd, T, stats
    mp.setattr(global_opt.FactorGraph, "solve_poses", stuck)


def _pose_unchanged(mp):
    """A tracking step that returns the frame's pose unchanged."""
    from mast3r_slam_torch import tracker

    track = tracker.FrameTracker.track

    def stuck(self, frame, keyframe):
        new_kf, fr, kf, lost, reuse = track(self, frame, keyframe)
        return new_kf, fr.replace(T_WC=frame.T_WC), kf, lost, reuse
    mp.setattr(tracker.FrameTracker, "track", stuck)


@pytest.mark.parametrize("fault,workload", [
    (_pointmap_altered, "vitl512-bf16.solo-panhold"),
    (_ba_unchanged, "vitl512-bf16.solo-panhold"),
    (_pose_unchanged, "vitl512-bf16.solo-panhold"),
    (_pose_unchanged, "vitl512-int8.solo-still")],
    ids=["pointmap_altered", "ba_unchanged", "pose_unchanged",
         "pose_unchanged_still"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    out = _run(monkeypatch, fault, workload)
    assert out["correct"] is False, out["checks"]
