"""The port's rates tool (``mast3r_slam_torch/tools/make_rates.py``) and
approximation sweep (``tools/sweep_approximations.py``) against the JAX
package.

* ``make_rates --frames 24 --res 48 64`` writes ``main.py``'s rate keys,
  ``ate_rmse`` and a ``provenance`` naming the tool, and its cadence
  figures (the keyframe, retrieval-proposal and accepted-edge rates, the
  desc_global batches and fallback rate, the mean GN and BA iterations)
  equal those of JAX's ``main.py --rates-out`` run over the same clip with
  the same flags: the oracle drive takes the same decisions on both sides.
  The clip's ``logs/rates_run`` outputs are removed after the module.
  Without ``--cpu`` the tool's ``main_torch.py`` runs on the card.
* ``sweep_approximations --frames 10 --res 32 48 --scenes smooth
  --variants production,reference_exact`` prints the markdown table of its
  runs, and each run's ATE is within 1e-4 m of JAX's ``SLAMSystem`` over
  the same sequence and config (read 6.9e-7 and 3.3e-7).  At ``--frames 8``
  neither package scores the run: it makes one keyframe, and both
  ``ate_rmse`` refuse a single association.

The JAX runs (``main.py``, and ``tests/_torch_sweep_jax_worker.py`` per
variant) are processes started with the module, beside its other tests:
most of their time is XLA compiles on the CPU.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mast3r_slam_torch.testing import SyntheticSequence
from mast3r_slam_torch.tools import make_rates, sweep_approximations

REPO = pathlib.Path(__file__).resolve().parent.parent
CLIP = "rates_clip_torchref"
RATE_KEYS = ("frames", "kf_rate", "retrieval_edge_rate",
             "retrieval_proposal_rate", "mean_gn_iters", "mean_ba_iters",
             "ba_ok_rate", "desc_edge_batches", "desc_fallback_rate",
             "config", "dataset", "retrieval_active", "reference_exact")
CADENCE = ("frames", "kf_rate", "retrieval_edge_rate",
           "retrieval_proposal_rate", "mean_gn_iters", "mean_ba_iters",
           "ba_ok_rate", "desc_edge_batches", "desc_fallback_rate")
SWEEP = dict(frames=10, res=(32, 48), scene="smooth",
             variants=("production", "reference_exact"))
SWEEP_ATE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(argv, log):
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *map(str, argv)], cwd=REPO,
                                stdout=f, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """JAX's runs, each a process started before the module's first test
    so that they run beside it (most of their time is XLA compiles): its
    ``main.py`` with ``scripts/make_rates.py``'s flags over the rates
    tool's clip (``make_rates.write_clip`` at the test's arguments), and
    ``tests/_torch_sweep_jax_worker.py`` per variant over the sweep's
    sequence.  The tests that read them wait under a deadline.  Yields the
    clip, the path of JAX's rates, the sweep's sequence and {"main" or a
    variant: (process, log)}."""
    tmp = tmp_path_factory.mktemp("jax")
    clip = tmp / CLIP
    make_rates.write_clip(clip, 24, 48, 64)
    h, w = SWEEP["res"]
    seq = SyntheticSequence(
        n_frames=SWEEP["frames"], h=h, w=w, seed=2,
        traj_scale=sweep_approximations.scenes_for(False)[SWEEP["scene"]],
        scene=SWEEP["scene"])
    seq.save(tmp / "seq.npz")
    np.save(tmp / "images.npy", np.stack(seq.images))
    procs = {}
    try:
        procs["main"] = (_start(
            [REPO / "main.py", "--dataset", clip, "--config",
             "config/eval_no_calib.yaml", "--no-viz", "--oracle",
             "--oracle-desc", "--oracle-retrieval", "--cpu", "--gt",
             clip / "gt.txt", "--ate-max-diff", "0.05", "--rates-out",
             tmp / "jax_rates.json", "--save-as", tmp / "jax_run"],
            tmp / "main.log"), tmp / "main.log")
        for v in SWEEP["variants"]:
            procs[v] = (_start([REPO / "tests" / "_torch_sweep_jax_worker.py",
                                tmp, v, max(h, w)], tmp / f"{v}.log"),
                        tmp / f"{v}.log")
        yield {"clip": clip, "rates": tmp / "jax_rates.json",
               "sweep_seq": seq, "procs": procs}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _wait(jax_runs, name):
    proc, log = jax_runs["procs"][name]
    assert proc.wait(timeout=600) == 0, log.read_text()[-4000:]
    return log.read_text()


@pytest.fixture(scope="module")
def rates_run(tmp_path_factory):
    """The port's tool at ``--frames 24 --res 48 64``; its
    ``logs/rates_run`` outputs are removed after the module.  Yields (its
    rates, its clip)."""
    tmp = tmp_path_factory.mktemp("rates")
    clip = tmp / CLIP
    out = tmp / "rates.json"
    run_dir = REPO / "logs" / "rates_run"
    omp = os.environ.get("OMP_NUM_THREADS")
    try:
        # the tool's main_torch.py process on one thread, as the module's
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            assert make_rates.main(["--frames", "24", "--res", "48", "64",
                                    "--out", str(out), "--clip",
                                    str(clip), "--cpu"]) == 0
        finally:
            if omp is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = omp
        with open(out) as f:
            yield json.load(f), clip
    finally:
        for suffix in (".txt", ".ply"):
            (run_dir / f"{CLIP}{suffix}").unlink(missing_ok=True)
        shutil.rmtree(run_dir / "keyframes" / CLIP, ignore_errors=True)


def test_make_rates_writes_main_py_keys(rates_run):
    port = rates_run[0]
    assert tuple(port) == RATE_KEYS + ("ate_rmse", "provenance")
    assert port["frames"] == 12           # eval_no_calib takes every other
    assert port["retrieval_active"] is True
    assert port["reference_exact"] is False
    assert 0 < port["ate_rmse"] <= make_rates.ATE_MAX
    assert port["provenance"].startswith(
        "mast3r_slam_torch/tools/make_rates.py: 24-frame closed-loop clip "
        "at 48x64")


@pytest.mark.parametrize("flags", [[], ["--cpu"]], ids=["card", "cpu"])
def test_make_rates_runs_on_the_card_unless_cpu(flags, monkeypatch,
                                                 tmp_path):
    """The tool's drive runs on the card by default: ``--cpu`` reaches
    ``main_torch.py`` only when it is given."""
    seen = []

    def run(argv, **kw):
        seen.append(argv)
        raise InterruptedError

    monkeypatch.setattr(make_rates, "write_clip", lambda *a: 1)
    monkeypatch.setattr(make_rates.subprocess, "run", run)
    with pytest.raises(InterruptedError):
        make_rates.main(["--clip", str(tmp_path / "clip"), *flags])
    assert seen[0][1].endswith("main_torch.py")
    assert ("--cpu" in seen[0]) == bool(flags)


def test_sweep_prints_table_and_matches_jax(jax_runs, capsys):
    from mast3r_slam_torch.utils.config import load_config

    seq = jax_runs["sweep_seq"]
    h, w = SWEEP["res"]
    assert sweep_approximations.main(
        ["--frames", str(SWEEP["frames"]), "--res", str(h), str(w),
         "--scenes", SWEEP["scene"], "--variants",
         ",".join(SWEEP["variants"]), "--cpu"]) == 0
    out, err = capsys.readouterr()
    table = [ln for ln in out.splitlines() if ln.startswith("|")]
    assert table[:2] == ["| scene | production | reference_exact |",
                         "|---|---|---|"]
    assert len(table) == 3 and table[2].startswith("| smooth | ")
    printed = [float(x) for x in table[2].split("|")[2:4]]
    assert len([ln for ln in err.splitlines()
                if ln.startswith("  smooth")]) == 2

    base = load_config("config/eval_no_calib.yaml")
    base["dataset"]["img_size"] = max(h, w)
    for name, shown in zip(SWEEP["variants"], printed):
        mods = sweep_approximations.variants_for(False)[name]
        ate, _ = sweep_approximations.run_one(
            sweep_approximations.variant_config(base, mods), seq, 0.0,
            False, "cpu")
        assert f"{ate:.4f}" == f"{shown:.4f}"
        jax_ate = float(_wait(jax_runs, name).splitlines()[-1])
        print(f"{name}: ATE {ate!r} m, JAX {jax_ate!r} m")
        assert np.isfinite(ate)
        assert abs(ate - jax_ate) <= SWEEP_ATE_ATOL


def test_make_rates_cadence_equals_jax_main(rates_run, jax_runs):
    port, clip = rates_run
    # JAX ran over the clip the tool's own writer gave, byte for byte
    names = sorted(p.name for p in clip.iterdir() if p.suffix in (
        ".png", ".txt"))
    assert names == sorted(p.name for p in jax_runs["clip"].iterdir()
                           if p.suffix in (".png", ".txt"))
    assert all((clip / n).read_bytes() == (jax_runs["clip"] / n).read_bytes()
               for n in names)
    _wait(jax_runs, "main")
    with open(jax_runs["rates"]) as f:
        jax_rates = json.load(f)
    assert set(jax_rates) == set(RATE_KEYS)
    print({k: (port[k], jax_rates[k]) for k in CADENCE})
    assert port["retrieval_proposal_rate"] > 0 and \
        port["desc_edge_batches"] > 0
    assert {k: port[k] for k in CADENCE} == \
        {k: jax_rates[k] for k in CADENCE}
