"""The port's evaluation harness (``mast3r_slam_torch/tools/eval_protocol.py``)
and clip writer (``tools/make_synthetic_clip.py``) against the JAX scripts
they mirror, ``scripts/eval_protocol.py`` and
``scripts/make_synthetic_clip.py``.

* The suites' sequence lists and protocol settings equal JAX's.
* The clip tool on the same arguments writes JAX's files: ``calibration.txt``
  byte for byte; ``gt.txt`` and ``oracle.npz``'s poses within 1e-6 (read
  8.94e-7: the two renderers' f32 rounding), its ``X_cam`` / ``X_world``
  within 1e-5 (read 5.25e-6 on points up to 8.3 m, a few ulp), its ``K``,
  ``h``, ``w`` and timestamps equal; the decoded PNGs' uint8 pixels at least
  99.99% equal and none more than 1 level apart (read 99.99932%).
* The runner end to end on the 48-frame 48x64 clip with ``--main-args
  "--oracle --cpu"``: ``main_torch.py`` at ``config/eval_no_calib.yaml``,
  the ATE under the JAX test's 0.05 m, then a score-only pass that
  reproduces the same number.
* Its ATE against ``scripts/eval_protocol.run_suite`` (JAX's ``main.py``) on
  the same clip within 5e-6 m (read 6.8e-7).  That suite is named
  ``synthetic_torchref``, so its table never meets the JAX test's
  ``logs/ate_synthetic_no_calib.json``; what it writes under ``logs/`` is
  removed after the module.  The JAX run takes about 50 s and runs once.
"""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image

from mast3r_slam_torch.tools import eval_protocol, make_synthetic_clip

REPO = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES, H, W = 48, 48, 64
GT_ATOL, X_ATOL = 1e-6, 1e-5
PIXELS_EQUAL_MIN = 0.9999
ATE_LIMIT, ATE_JAX_ATOL = 0.05, 5e-6
REF_SUITE = "synthetic_torchref"


def _jax_script(name):
    """A script under ``scripts/`` as a module of its own name, so that it
    never shares ``sys.modules`` with the JAX tests' import of it."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_eval_protocol = _jax_script("eval_protocol")


@pytest.mark.parametrize("name", ["TUM_SEQUENCES", "EUROC_SEQUENCES",
                                  "SEVEN_SCENES_SEQUENCES",
                                  "ETH3D_SEQUENCES"])
def test_sequence_lists_match_jax(name):
    """eval_tum.sh:3-13, eval_euroc.sh:3-17, eval_7_scenes.sh:3-11,
    eval_eth3d.sh:4-63, as the JAX harness holds them."""
    assert getattr(eval_protocol, name) == getattr(jax_eval_protocol, name)
    assert len(eval_protocol.TUM_SEQUENCES) == 9
    assert len(eval_protocol.EUROC_SEQUENCES) == 11
    assert len(eval_protocol.SEVEN_SCENES_SEQUENCES) == 7
    assert len(eval_protocol.ETH3D_SEQUENCES) >= 50


def test_suites_match_jax():
    def fields(s):
        return (s.name, s.sequences, s.dataset_root, s.gt, s.max_diff,
                s.calib_choice, s.config, s.gt_file(s.sequences[0]))

    assert sorted(eval_protocol.SUITES) == sorted(jax_eval_protocol.SUITES)
    for k, suite in eval_protocol.SUITES.items():
        assert fields(suite) == fields(jax_eval_protocol.SUITES[k])


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The 48-frame 48x64 clip written by the port's tool and by the JAX
    script on the same arguments."""
    root = tmp_path_factory.mktemp("clips")
    port, jax_clip = root / "port", root / "jax"
    argv = [str(N_FRAMES), str(H), str(W)]
    assert make_synthetic_clip.main([str(port), *argv]) == 0
    subprocess.run([sys.executable, "scripts/make_synthetic_clip.py",
                    str(jax_clip), *argv], cwd=REPO, check=True,
                   capture_output=True)
    return port, jax_clip


def test_clip_frames_match_jax(clips):
    port, jax_clip = clips
    names = sorted(p.name for p in jax_clip.glob("*.png"))
    assert names == sorted(p.name for p in port.glob("*.png"))
    assert len(names) == N_FRAMES
    a = np.stack([np.asarray(Image.open(port / n)) for n in names])
    b = np.stack([np.asarray(Image.open(jax_clip / n)) for n in names])
    assert a.shape == b.shape == (N_FRAMES, H, W, 3)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert (diff == 0).mean() >= PIXELS_EQUAL_MIN
    assert diff.max() <= 1


def test_clip_ground_truth_matches_jax(clips):
    port, jax_clip = clips
    assert (port / "calibration.txt").read_bytes() == \
        (jax_clip / "calibration.txt").read_bytes()
    a, b = np.loadtxt(port / "gt.txt"), np.loadtxt(jax_clip / "gt.txt")
    assert a.shape == b.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a, b, rtol=0, atol=GT_ATOL)


def test_clip_oracle_matches_jax(clips):
    port, jax_clip = clips
    a, b = np.load(port / "oracle.npz"), np.load(jax_clip / "oracle.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        atol = {"T_WC": GT_ATOL, "X_cam": X_ATOL, "X_world": X_ATOL}.get(k)
        if atol is None:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=k)


def _suite(name, clips):
    """A suite of the one sequence ``clip`` (the port's clip, with
    ``gt.txt`` as its ``groundtruth.txt``) under a root of its own."""
    port, _ = clips
    root = port.parent / f"root_{name}"
    if not root.exists():
        shutil.copytree(port, root / "clip")
        shutil.copy(root / "clip" / "gt.txt", root / "clip" / "groundtruth.txt")
    return eval_protocol.Suite(name, ["clip"], root, "dataset", 0.05)


def _args(tmp, print_only=False):
    return types.SimpleNamespace(
        sequences=None, no_calib=True, print=print_only,
        main_args=f"--oracle --cpu --rates-out {tmp}/rates.json")


@pytest.fixture(scope="module")
def port_run(clips, tmp_path_factory):
    """The port's runner over the clip, its logs in a temporary root:
    (exit code, the table, the logs root)."""
    logs = tmp_path_factory.mktemp("logs")
    mp = pytest.MonkeyPatch()
    mp.setattr(eval_protocol, "LOGS", logs)
    # main_torch.py on one PyTorch thread: the suite runs in several worker
    # processes at once
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        suite = _suite("synthetic", clips)
        rc = eval_protocol.run_suite(suite, _args(logs))
        with open(logs / "ate_synthetic_no_calib_torch.json") as f:
            table = json.load(f)
        yield rc, table, logs, suite
    finally:
        mp.undo()


def test_protocol_runner_end_to_end(port_run, monkeypatch, capsys):
    """One command -> run + score + JSON table; the score-only pass
    reproduces the number and prints the same table."""
    rc, table, logs, suite = port_run
    assert rc == 0
    assert (logs / "synthetic" / "no_calib" / "clip" / "clip.txt").exists()
    assert table["n_scored"] == table["n_total"] == 1
    assert table["suite"] == "synthetic" and table["mode"] == "no_calib"
    assert table["ate_rmse"]["clip"] < ATE_LIMIT, table
    assert table["mean"] == table["ate_rmse"]["clip"]
    monkeypatch.setattr(eval_protocol, "LOGS", logs)
    assert eval_protocol.run_suite(suite, _args(logs, print_only=True)) == 0
    out = capsys.readouterr().out
    assert "== synthetic (no_calib) ATE RMSE [m], Sim3-aligned ==" in out
    assert f"  {'clip':42s}  {table['ate_rmse']['clip']:.4f}" in out
    with open(logs / "ate_synthetic_no_calib_torch.json") as f:
        assert json.load(f) == table


def test_protocol_runner_without_a_run_exits_1(clips, tmp_path,
                                                monkeypatch, capsys):
    """A score-only pass with nothing to score prints the sequence as
    missing and exits 1, as the JAX harness does."""
    monkeypatch.setattr(eval_protocol, "LOGS", tmp_path)
    suite = _suite("synthetic", clips)
    assert eval_protocol.run_suite(suite, _args(tmp_path, True)) == 1
    assert "------   missing est" in capsys.readouterr().out
    with open(tmp_path / "ate_synthetic_no_calib_torch.json") as f:
        assert json.load(f)["n_scored"] == 0


@pytest.fixture(scope="module")
def jax_run(clips, tmp_path_factory):
    """``scripts/eval_protocol.run_suite`` (JAX's ``main.py``) over the same
    clip as the suite ``synthetic_torchref``; its logs are removed after."""
    tmp = tmp_path_factory.mktemp("jax_rates")
    suite = _suite(REF_SUITE, clips)
    table = REPO / "logs" / f"ate_{REF_SUITE}_no_calib.json"
    try:
        rc = jax_eval_protocol.run_suite(suite, _args(tmp))
        with open(table) as f:
            yield rc, json.load(f)
    finally:
        table.unlink(missing_ok=True)
        shutil.rmtree(REPO / "logs" / REF_SUITE, ignore_errors=True)


def test_protocol_ate_matches_jax_harness(port_run, jax_run):
    rc, table, _, _ = port_run
    jrc, jtable = jax_run
    assert rc == jrc == 0
    assert jtable["n_scored"] == 1
    print(f"ATE on the 48-frame clip: the port {table['ate_rmse']['clip']!r}"
          f" m, JAX {jtable['ate_rmse']['clip']!r} m")
    assert abs(table["ate_rmse"]["clip"] - jtable["ate_rmse"]["clip"]) \
        <= ATE_JAX_ATOL, (table, jtable)
