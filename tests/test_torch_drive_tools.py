"""The port's drive tools against the JAX scripts they mirror, on a port run
of the 48-frame 48x64 synthetic clip (``main_torch.py --oracle --cpu`` at
``config/eval_no_calib.yaml``: 24 protocol frames, 3 keyframes, 2 BA
rounds).

* ``mast3r_slam_torch/tools/analyze_drive.py`` prints what
  ``scripts/analyze_drive.py`` prints, character for character, on the
  same ``--diag-out`` file, clip and ``--est`` trajectory (both read files
  only, so the port's run serves both).
* ``tools/segmented_drive.py --cpu`` in 3 segments of 8 protocol frames
  (``--state-out`` / ``--resume-state`` between fresh processes) gives the
  one-process run's stats and trajectory file byte for byte (read: equal;
  resume is bitwise on the CPU, ``tests/test_torch_state.py``).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

from mast3r_slam_torch.tools import (analyze_drive, make_synthetic_clip,
                                     segmented_drive)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "config/eval_no_calib.yaml"
SEGMENT = 8
# the port's processes on one PyTorch thread each: the suite runs in
# several worker processes at once, and PyTorch's default pool in each of
# them oversubscribes the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _stats_line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("stats: ")]
    return lines[-1]


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """(clip, one-process run's directory, its stdout): the clip from the
    port's tool, then ``main_torch.py`` over it in one process with
    ``--diag-out``."""
    root = tmp_path_factory.mktemp("drive")
    clip = root / "clip"
    assert make_synthetic_clip.main([str(clip), "48", "48", "64"]) == 0
    run = root / "one"
    out = subprocess.run(
        [sys.executable, "main_torch.py", "--dataset", str(clip), "--config",
         CONFIG, "--oracle", "--cpu", "--no-viz", "--save-as", str(run),
         "--diag-out", str(run / "diag.jsonl"),
         "--rates-out", str(run / "rates.json")],
        cwd=REPO, check=True, capture_output=True, text=True,
        env={**os.environ, **ONE_THREAD}).stdout
    return clip, run, out


@pytest.mark.parametrize("with_est", [False, True], ids=["diag", "diag+est"])
def test_analyze_drive_prints_the_jax_report(drive, capsys, with_est):
    clip, run, _ = drive
    argv = [str(run / "diag.jsonl"), str(clip)]
    if with_est:
        argv += ["--est", str(run / "clip.txt")]
    assert analyze_drive.main(argv) == 0
    port = capsys.readouterr().out
    jax_out = subprocess.run(
        [sys.executable, "scripts/analyze_drive.py", *argv], cwd=REPO,
        check=True, capture_output=True, text=True).stdout
    assert port == jax_out
    assert "24 diag rows; GT 48 frames" in port
    assert ("final keyframe poses vs GT (post-BA):" in port) == with_est


@pytest.mark.parametrize("tool,uses", [
    ("analyze_drive", ""),
    ("eval_protocol", "mast3r_slam_torch.evaluate"),
    ("make_synthetic_clip", "mast3r_slam_torch.testing"),
    ("segmented_drive", "mast3r_slam_torch.utils.config")])
def test_tools_import_no_jax(tool, uses):
    """Each tool runs where JAX and ``cv2`` are not installed: in a fresh
    interpreter, importing it and the port module its ``main`` imports
    loads no module of JAX, ``cv2`` or the JAX package."""
    code = ("import importlib, sys; before = set(sys.modules); "
            f"importlib.import_module('mast3r_slam_torch.tools.{tool}'); "
            f"{uses!r} and importlib.import_module({uses!r}); "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', "
            "'mast3r_slam_tpu')); print(bad); sys.exit(1 if bad else 0)")
    assert importlib.util.find_spec("jax") is not None
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_segmented_drive_matches_one_process_run(drive, tmp_path, capfd,
                                                 monkeypatch):
    clip, run, out = drive
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    seg = tmp_path / "seg"
    assert segmented_drive.main(
        ["--dataset", str(clip), "--config", CONFIG, "--segment",
         str(SEGMENT), "--save-as", str(seg), "--rates-out",
         str(tmp_path / "rates.json"), "--oracle", "--cpu"]) == 0
    seg_out = capfd.readouterr().out
    assert seg_out.count("[segment ") == 3
    assert "[segment 3/3] frames 16..23" in seg_out
    assert seg_out.count("resumed from ") == 2
    assert _stats_line(seg_out) == _stats_line(out)
    assert (seg / "clip.txt").read_text() == (run / "clip.txt").read_text()
