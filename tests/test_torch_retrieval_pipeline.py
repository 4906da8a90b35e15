"""The port's SLAM system with an ASMK retrieval database against the JAX
package's, on the oracle clips of ``tests/test_retrieval.py``.

Both sides run ``make_oracle_retrieval`` over the same clip (the same
k-means codebook and random head) with the backend inline
(``config/eval_no_calib.yaml``, ``single_thread: True``):

* the relocalization clip (``:119``; 14 frames, frame 6 blacked out): the
  same mode sequence, stats, relocalization attempts and edges; the
  retrieval's proposals bring the system back to TRACKING;
* the 24-frame loop clip (``:216``; ``noise_std 0.01``, seed 7), with and
  without retrieval, and with ``export_desc`` (``:390``), which makes the
  loop-closure edges ``desc_global`` ones and sends the pairs its gates
  reject to the symmetric decode: equal stats, edges, ``n_desc_batches``,
  ``n_desc_fallbacks`` and BA iteration totals; a loop-closure edge
  (|i - j| > 1) where retrieval is on; keyframe poses within ``POSE_ATOL``
  5e-5 (measured 9.2e-6 at most, the desc_global run) and ATE within
  ``ATE_ATOL`` 1e-5 of JAX's (measured 1.9e-6).  What differs is f32
  summation order in the GN and BA solves: every match, proposal and gate
  is equal.
"""


import numpy as np
import pytest
import torch

from mast3r_slam_tpu import evaluate as jevaluate
from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils import config as jconfig
from mast3r_slam_torch import evaluate, testing
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

H, W = 32, 48
POSE_ATOL = 5e-5
ATE_ATOL = 1e-5
RELOC = dict(n_frames=14, h=H, w=W, seed=0, traj_scale=0.4)
LOOP = dict(n_frames=24, h=H, w=W, seed=3, traj_scale=0.35, loop=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(load):
    """``config/eval_no_calib.yaml``, whose ``retrieval_edge_mode`` is
    ``desc_global`` (from ``config/base.yaml``): keyframes without stored
    tables (an oracle without ``export_desc``) take the symmetric path."""
    cfg = load("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = W
    assert cfg["local_opt"]["retrieval_edge_mode"] == "desc_global"
    return cfg


def _drive(system, seq):
    modes = [system.process_frame(i, seq.images[i])["mode"]
             for i in range(len(seq.X_cam))]
    system.terminate()
    return modes


def _ate(save_traj, seq, arena, d, name):
    save_traj(d, name, seq.timestamps, arena)
    seq.write_gt(d / "gt.txt")
    return jevaluate.ate_rmse(d / "gt.txt", d / name, max_diff=0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' systems per clip, run once for the tests that read
    them: (JAX system, its modes, its ATE, port system, modes, ATE)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        d = tmp_path_factory.mktemp(name)
        reloc = name == "reloc"
        jseq = jtesting.SyntheticSequence(**(RELOC if reloc else LOOP))
        jseq.save(d / "o.npz")
        tseq = testing.SyntheticSequence.load(d / "o.npz")
        ekw = dict(blackout_frames={6}) if reloc else \
            dict(noise_std=0.01, seed=7, export_desc=name == "desc")
        jeng = jtesting.OracleEngine(jseq, **ekw)
        jsys = JaxSLAMSystem(
            _cfg(jconfig.load_config), jeng, (H, W), buffer=32,
            retrieval=None if name == "loop_off" else
            jtesting.make_oracle_retrieval(jseq, jeng))
        teng = testing.OracleEngine(tseq, device="cpu", **ekw)
        tsys = SLAMSystem(
            _cfg(load_config), teng, (H, W), buffer=32, device="cpu",
            retrieval=None if name == "loop_off" else
            testing.make_oracle_retrieval(tseq, teng))
        jmodes, tmodes = _drive(jsys, jseq), _drive(tsys, jseq)
        jate = tate = None
        if not reloc:
            jate = _ate(jevaluate.save_traj, jseq, jsys.arena, d, "jax.txt")
            tate = _ate(evaluate.save_traj, jseq, tsys.arena, d, "port.txt")
        cache[name] = (jsys, jmodes, jate, tsys, tmodes, tate)
        return cache[name]

    return get


def _edges(g):
    return g.ii[:g.n_edges].tolist(), g.jj[:g.n_edges].tolist()


def _assert_same_system(jsys, tsys):
    assert tsys.stats == jsys.stats
    assert _edges(tsys.graph) == _edges(jsys.graph)
    assert tsys.ba_iters_total == jsys.ba_iters_total
    assert tsys.ba_ok_total == jsys.ba_ok_total
    assert tsys.graph.n_desc_batches == getattr(jsys.graph,
                                                "n_desc_batches", 0)
    assert tsys.graph.n_desc_fallbacks == getattr(jsys.graph,
                                                  "n_desc_fallbacks", 0)
    n = tsys.arena.n_size
    assert n == int(jsys.arena.n_size)
    err = float(np.abs(tsys.arena.T_WC[:n].numpy()
                       - np.asarray(jsys.arena.T_WC[:n])).max())
    print(f"keyframe poses: max abs difference {err:.3g}")
    assert err <= POSE_ATOL


def test_relocalization_with_retrieval_matches_jax(runs):
    """Tracking is lost at frame 6; the database's proposals relocalize
    the system on the same frame in both packages."""
    jsys, jmodes, _, tsys, tmodes, _ = runs("reloc")
    assert tmodes == jmodes
    assert tmodes[6] == "TRACKING->RELOC" and "RELOC" in tmodes
    recovered = [i for i in range(1, len(tmodes))
                 if tmodes[i - 1] == "RELOC" and tmodes[i] == "TRACKING"]
    assert len(recovered) == 1, tmodes
    assert tsys.mode.name == jsys.mode.name == "TERMINATED"
    assert tsys.reloc_attempts == jsys.reloc_attempts >= 1
    assert tsys.stats["skipped"] == 1 and tsys.stats["tracked"] >= 8
    _assert_same_system(jsys, tsys)


@pytest.mark.parametrize("name", ["loop_off", "loop", "desc"],
                         ids=["no-retrieval", "retrieval", "desc_global"])
def test_loop_clip_matches_jax(runs, name):
    jsys, jmodes, jate, tsys, tmodes, tate = runs(name)
    assert tmodes == jmodes
    _assert_same_system(jsys, tsys)
    ii, jj = _edges(tsys.graph)
    span = np.abs(np.asarray(ii) - np.asarray(jj))
    if name == "loop_off":
        assert (span <= 1).all() and tsys.stats["retrieval_proposals"] == 0
    else:
        assert (span > 1).any() and tsys.stats["retrieval_edges"] >= 1
    if name == "desc":
        assert tsys.graph.n_desc_batches >= 1
        assert tsys.graph.n_desc_fallbacks <= \
            tsys.stats["retrieval_proposals"]
        # every keyframe's stored q8 table and confidence, bitwise
        store, jstore = tsys.graph.desc_store, jsys.graph.desc_store
        assert sorted(store) == sorted(jstore) == list(range(
            tsys.arena.n_size))
        for r, (d8, dc) in store.items():
            assert d8.dtype == torch.int8
            np.testing.assert_array_equal(d8.numpy(), np.asarray(jstore[r][0]))
            np.testing.assert_array_equal(dc.numpy(), np.asarray(jstore[r][1]))
    else:
        assert tsys.graph.n_desc_batches == 0
    print(f"loop clip {name}: ATE port {tate:.6f} m, JAX {jate:.6f} m")
    assert abs(tate - jate) <= ATE_ATOL, (tate, jate)


def test_failed_relocalization_drops_the_rows_table(monkeypatch):
    """A relocalization attempt that fails pops its keyframe again, and a
    q8 table stored under that row goes with it (pipeline.py:672): the next
    keyframe reuses the row.  The blackout clip with the oracle's
    descriptors, a retrieval stub proposing keyframe 0 and edges that never
    pass."""
    seq = testing.SyntheticSequence(**RELOC)
    engine = testing.OracleEngine(seq, blackout_frames={6}, export_desc=True,
                                  device="cpu")

    class ProposeFirst:
        def update(self, frame, arena, add_after_query, k, min_thresh):
            return [0]

    system = SLAMSystem(_cfg(load_config), engine, (H, W), buffer=32,
                        retrieval=ProposeFirst(), device="cpu")
    for i in range(7):
        system.process_frame(i, seq.images[i])
    assert system.mode.name == "RELOC"
    g, n = system.graph, system.arena.n_size
    assert sorted(g.desc_store) == list(range(n))
    g.desc_store[n] = g.desc_store[0]
    monkeypatch.setattr(g, "add_factors", lambda *a, **kw: False)
    system.process_frame(7, seq.images[7])
    assert system.mode.name == "RELOC" and system.arena.n_size == n
    assert sorted(g.desc_store) == list(range(n))
