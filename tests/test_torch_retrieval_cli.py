"""``main_torch.py`` with the retrieval flags, against the JAX package.

* ``--oracle --oracle-desc --oracle-retrieval`` on a written 24-frame loop
  clip (``tests/test_retrieval.py:216``) at ``config/eval_no_calib.yaml``
  against the JAX ``SLAMSystem`` on the same frames: the same stats, edges,
  ``desc_global`` counts and BA iteration total, ATE within ``ATE_ATOL``
  1e-5 (measured 6e-8); its ``desc_global edge batches`` line and its
  ``--rates-out`` file with ``main.py``'s keys.
* Exit 0 where the run ends in RELOC (the blackout clip of ``:119`` without
  retrieval), as ``main.py``, with one line that says the run ended lost;
  with the oracle database the same clip relocalizes.
* ``--retrieval-checkpoint`` / ``--codebook``: the database built from a
  forged head and codebook, or one ``[warn]`` line where they are missing.
"""

import copy
import json
import pickle

import numpy as np
import pytest
import torch

import main_torch
from mast3r_slam_tpu import evaluate as jevaluate
from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import evaluate, testing
from mast3r_slam_torch.retrieval.database import RetrievalDatabase

H, W = 32, 48
ATE_ATOL = 1e-5
RELOC = dict(n_frames=14, h=H, w=W, seed=0, traj_scale=0.4)
LOOP = dict(n_frames=24, h=H, w=W, seed=3, traj_scale=0.35, loop=True)
# the keys of main.py's rates dict (main.py:365-410)
RATES_KEYS = {"frames", "kf_rate", "retrieval_edge_rate",
              "retrieval_proposal_rate", "mean_gn_iters", "mean_ba_iters",
              "ba_ok_rate", "desc_edge_batches", "desc_fallback_rate",
              "config", "dataset", "retrieval_active", "reference_exact"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(g):
    return g.ii[:g.n_edges].tolist(), g.jj[:g.n_edges].tolist()


def _cli(tmp_path, monkeypatch, argv):
    """``main_torch.main(argv)`` from ``tmp_path`` (with the repository's
    ``config``); returns (exit code, the system it ran)."""
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    if not (tmp_path / "config").exists():
        (tmp_path / "config").symlink_to(root / "config")
    systems = []
    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(main_torch, "run", spy)
    rc = main_torch.main(argv)
    return rc, systems[0]


def test_main_torch_oracle_retrieval_desc_matches_jax(tmp_path, monkeypatch,
                                                     capsys):
    """``--oracle --oracle-desc --oracle-retrieval`` on the loop clip at
    ``config/eval_no_calib.yaml`` (every second frame, desc_global edges):
    the JAX system on the same 12 frames gives the same stats, edges and
    desc_global counts, and an ATE within ``ATE_ATOL`` of the one the CLI
    prints (to its 1e-4); the rates file holds ``main.py``'s keys."""
    jseq = jtesting.SyntheticSequence(**LOOP)
    d = tmp_path / "clip"
    d.mkdir()
    jseq.save(d / "oracle.npz")
    tseq = testing.SyntheticSequence.load(d / "oracle.npz")
    tseq.images = [np.asarray(im) for im in jseq.images]
    testing.write_clip(tseq, d)
    rc, system = _cli(tmp_path, monkeypatch, [
        "--dataset", str(d), "--config", "config/eval_no_calib.yaml",
        "--oracle", "--oracle-desc", "--oracle-retrieval", "--cpu",
        "--no-viz", "--gt", str(d / "gt.txt"), "--ate-max-diff", "0.05",
        "--save-as", "run", "--rates-out", "logs/rates.json"])
    out = capsys.readouterr().out
    assert rc == 0
    assert isinstance(system.retrieval, RetrievalDatabase)
    assert "oracle retrieval database on" in out
    g = system.graph
    assert f"desc_global edge batches: {g.n_desc_batches}\n" in out
    assert g.n_desc_batches >= 1

    sub = int(system.cfg["dataset"]["subsample"])
    jsub = copy.copy(jseq)
    jsub.X_cam, jsub.X_world = jseq.X_cam[::sub], jseq.X_world[::sub]
    jsub.T_WC, jsub.images = jseq.T_WC[::sub], jseq.images[::sub]
    jsub.timestamps = jseq.timestamps[::sub]
    jeng = jtesting.OracleEngine(jsub, export_desc=True)
    jcfg = jconfig.load_config("config/eval_no_calib.yaml")
    jcfg["dataset"]["img_size"] = W
    jsys = JaxSLAMSystem(jcfg, jeng, (H, W), buffer=512,
                         retrieval=jtesting.make_oracle_retrieval(jsub, jeng))
    for i in range(len(jsub.X_cam)):
        jsys.process_frame(i, jsub.images[i])
    jsys.terminate()
    assert system.stats == jsys.stats
    assert _edges(g) == _edges(jsys.graph)
    assert g.n_desc_batches == jsys.graph.n_desc_batches
    assert g.n_desc_fallbacks == getattr(jsys.graph, "n_desc_fallbacks", 0)
    assert system.ba_iters_total == jsys.ba_iters_total
    ate = float(out.split("ATE RMSE (Sim3-aligned):")[1].split()[0])
    jevaluate.save_traj(tmp_path, "jax.txt", jsub.timestamps, jsys.arena)
    jate = jevaluate.ate_rmse(d / "gt.txt", tmp_path / "jax.txt",
                              max_diff=0.05)
    evaluate.save_traj(tmp_path, "held.txt", jsub.timestamps, system.arena)
    held = evaluate.ate_rmse(d / "gt.txt", tmp_path / "held.txt",
                             max_diff=0.05)
    print(f"main_torch loop clip: ATE port {held:.6f} m (printed {ate}), "
          f"JAX {jate:.6f} m")
    assert abs(ate - held) <= 5e-5      # printed to 1e-4
    assert abs(held - jate) <= ATE_ATOL

    rates = json.loads((tmp_path / "logs" / "rates.json").read_text())
    assert set(rates) == RATES_KEYS
    n = len(jsub.X_cam)
    assert rates["frames"] == n and rates["retrieval_active"] is True
    assert rates["desc_edge_batches"] == g.n_desc_batches
    assert rates["kf_rate"] == system.stats["keyframes"] / n
    assert rates["desc_fallback_rate"] == g.n_desc_fallbacks / max(
        system.stats["retrieval_proposals"], 1)
    assert f"rates: {rates}" in out


class _BlackoutOracle(testing.OracleEngine):
    """The oracle with frame 6 blacked out (tests/test_retrieval.py:119)."""

    def __init__(self, seq, **kw):
        super().__init__(seq, blackout_frames={6}, **kw)


@pytest.mark.parametrize("retrieval", [False, True],
                         ids=["null-retrieval", "oracle-retrieval"])
def test_main_torch_exits_0_when_lost(tmp_path, monkeypatch, capsys,
                                      retrieval):
    """The blackout clip at ``config/base.yaml``: without retrieval the run
    ends in RELOC, says so in one line and exits 0, as ``main.py`` does
    (it returns nothing); with the oracle database it relocalizes and ends
    tracking."""
    seq = testing.SyntheticSequence(**RELOC)
    d = tmp_path / "clip"
    testing.write_clip(seq, d)
    monkeypatch.setattr(testing, "OracleEngine", _BlackoutOracle)
    argv = ["--dataset", str(d), "--config", "config/base.yaml", "--oracle",
            "--cpu", "--no-viz", "--save-as", "run", "--rates-out", ""]
    rc, system = _cli(tmp_path, monkeypatch,
                      argv + (["--oracle-retrieval"] if retrieval else []))
    out = capsys.readouterr().out
    assert rc == 0
    lost = [ln for ln in out.splitlines() if ln.startswith("[lost] the run")]
    assert system.stats["skipped"] == 1 and system.stats["reloc"] >= 1
    if retrieval:
        assert system.mode.name == "TERMINATED" and not lost
        assert system.stats["keyframes"] >= 2
    else:
        assert len(lost) == 1 and system.stats["keyframes"] == 1
    assert not (tmp_path / "logs" / "rates.json").exists()


def _forge_retrieval_files(d, d_in, words):
    """A retrieval head in the published state-dict layout and a codebook
    pickle in the published ``state_dict`` layout."""
    from mast3r_slam_torch.retrieval.model import RetrievalParams

    p = RetrievalParams.random(d_in, (d_in,), seed=0)
    torch.save({"model": {
        "projector.0.weight": p.proj_weights[0][0].T.contiguous(),
        "projector.0.bias": p.proj_weights[0][1],
        "prewhiten.m": p.prewhiten_m, "prewhiten.p": p.prewhiten_p,
        "postwhiten.m": p.postwhiten_m, "postwhiten.p": p.postwhiten_p}},
        d / "retrieval.pth")
    cent = np.random.default_rng(0).standard_normal((words, d_in)) \
        .astype(np.float32)
    with open(d / "codebook.pkl", "wb") as f:
        pickle.dump({"type": "Codebook", "params": {"size": words},
                     "state": {"centroids": cent}}, f)


@pytest.mark.parametrize("files", [False, True], ids=["missing", "forged"])
def test_main_torch_retrieval_checkpoint(tmp_path, monkeypatch, capsys,
                                         files):
    """A network run (``--tiny-model``, one frame): with the files of
    ``--retrieval-checkpoint`` and ``--codebook`` the database is built
    from them and indexes the first keyframe; without them one ``[warn]``
    line says loop closure and relocalization are off (main.py:269-277)."""
    seq = testing.SyntheticSequence(n_frames=2, h=H, w=W, seed=0)
    d = tmp_path / "clip"
    testing.write_clip(seq, d)
    _forge_retrieval_files(tmp_path, 64, 16) if files else None
    argv = ["--dataset", str(d), "--config", "config/base.yaml",
            "--tiny-model", "--cpu", "--no-viz", "--max-frames", "1",
            "--save-as", "run", "--retrieval-checkpoint",
            str(tmp_path / "retrieval.pth"), "--codebook",
            str(tmp_path / "codebook.pkl"), "--rates-out", "r.json"]
    rc, system = _cli(tmp_path, monkeypatch, argv)
    out = capsys.readouterr().out
    assert rc == 0
    warn = [ln for ln in out.splitlines() if ln.startswith("[warn] retrieval")]
    rates = json.loads((tmp_path / "r.json").read_text())
    assert rates["retrieval_active"] is files
    if files:
        assert not warn and "retrieval database loaded" in out
        assert isinstance(system.retrieval, RetrievalDatabase)
        assert system.retrieval.kf_counter == 1
        assert system.retrieval.codebook.size == 16
    else:
        assert len(warn) == 1 and "disabled" in warn[0]
        assert system.retrieval.__class__.__name__ == "NullRetrieval"
