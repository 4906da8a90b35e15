"""The backend on a device of its own (``SLAMSystem(backend_device=)``):
the counterparts of ``tests/test_pipeline_backend_device.py``'s three tests
on the port, and the port with a backend device against the JAX package's
``backend_device=1`` run.

The port runs on the CPU, whose one device is index 0: ``backend_device=0``
builds the mirror arena on the frontend's device, as JAX allows, and the
backend's edge store, decodes and BA read only the mirror.  JAX's run uses
device 1 of the 8 virtual CPU devices of ``tests/conftest.py``.  The clip
is the 16-frame 48x64 oracle clip of the JAX test.

Tolerances: the mirror run against the run without it, poses atol 1e-5
(JAX's; the same arithmetic on copies of the same rows: measured 0);
the threaded run, ATE < 0.05 m (JAX's; thread timing decides which rounds
see which frames); against JAX, equal stats and BA iteration totals.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_tpu.utils.config import load_config as jload_config
from mast3r_slam_torch import evaluate, testing
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

POSE_ATOL = 1e-5
ATE_LIMIT = 0.05
DRAIN_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """The JAX clip and the port's copy loaded from its .npz."""
    d = tmp_path_factory.mktemp("clip")
    jseq = jtesting.SyntheticSequence(n_frames=16, h=48, w=64, seed=0,
                                      traj_scale=0.5)
    jseq.save(d / "oracle.npz")
    tseq = testing.SyntheticSequence.load(d / "oracle.npz")
    tseq.images = [np.asarray(im) for im in jseq.images]
    return jseq, tseq


def _cfg(load, single_thread=True):
    cfg = load("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = 64
    cfg["single_thread"] = single_thread
    return cfg


def run(seq, backend_device=None, single_thread=True):
    system = SLAMSystem(_cfg(load_config, single_thread),
                        testing.OracleEngine(seq, device="cpu"),
                        (seq.h, seq.w), buffer=32, device="cpu",
                        backend_device=backend_device)
    for i in range(len(seq)):
        system.process_frame(i, seq.images[i])
    testing.drain_within(system, DRAIN_S)
    system.terminate()
    return system


@pytest.fixture(scope="module")
def runs(seqs):
    _, tseq = seqs
    return {"ref": run(tseq), "mirror": run(tseq, backend_device=0)}


def test_backend_device_matches_single_device(runs):
    """``backend_device=0`` against the same run without it: equal stats,
    edges and BA iterations, poses within 1e-5; the edge store and the
    mirror on the backend device, the mirror a copy of its own that holds
    the live arena's keyframes."""
    ref, split = runs["ref"], runs["mirror"]
    assert split.stats == ref.stats and ref.stats["ba_rounds"] >= 1
    assert split.ba_iters_total == ref.ba_iters_total
    g, rg = split.graph, ref.graph
    np.testing.assert_array_equal(g.ii[:g.n_edges], rg.ii[:rg.n_edges])
    n = ref.arena.n_size
    err = float((split.arena.T_WC[:n] - ref.arena.T_WC[:n]).abs().max())
    assert err <= POSE_ATOL, err
    dev = torch.device("cpu")
    assert split._bdev == dev and ref._bdev is None
    assert g.idx_ii2jj.device == dev and g.dev == dev
    m = split._marena
    assert m.X.device == dev and m.X is not split.arena.X
    assert m.n_size == n and split.mirror_rows_copied >= n
    # the rows below the last keyframe no longer change: the mirror holds
    # them as the live arena does
    assert torch.equal(m.X[:n - 1], split.arena.X[:n - 1])


def test_backend_device_threaded(seqs, tmp_path):
    """Threaded, with the backend device: the trajectory's ATE under the
    JAX test's 0.05 m (thread timing makes the rounds' inputs differ from
    the inline run's)."""
    _, tseq = seqs
    split = run(tseq, backend_device=0, single_thread=False)
    assert split.stats["keyframes"] >= 2 and split.stats["ba_rounds"] >= 1
    tseq.write_gt(tmp_path / "gt.txt")
    evaluate.save_traj(tmp_path, "est.txt", tseq.timestamps, split.arena)
    ate = evaluate.ate_rmse(tmp_path / "gt.txt", tmp_path / "est.txt",
                            max_diff=0.05)
    assert ate < ATE_LIMIT, ate


def test_backend_device_unavailable_falls_back(seqs, capsys):
    """An index past the devices prints JAX's one line and runs on one
    device, which is never another kind than the system's."""
    _, tseq = seqs
    system = run(tseq, backend_device=99)
    out = capsys.readouterr().out
    assert out.count("backend_device=99 unavailable (1 devices); running "
                     "single-device") == 1
    assert system._bdev is None
    assert system.stats["ba_rounds"] >= 1
    assert system.graph.dev == torch.device("cpu")


def test_backend_device_matches_jax(seqs, runs):
    """The port with ``backend_device=0`` against JAX's ``SLAMSystem`` with
    ``backend_device=1``: equal stats, edges and BA iteration totals."""
    jseq, _ = seqs
    jsys = JaxSLAMSystem(_cfg(jload_config), jtesting.OracleEngine(jseq),
                         (48, 64), buffer=32, backend_device=1)
    for i in range(len(jseq.images)):
        jsys.process_frame(i, jseq.images[i])
    jsys.terminate()
    assert jsys._bdev is not None
    split = runs["mirror"]
    assert split.stats == jsys.stats
    assert split.ba_iters_total == jsys.ba_iters_total
    g, jg = split.graph, jsys.graph
    np.testing.assert_array_equal(g.ii[:g.n_edges], jg.ii[:jg.n_edges])
    np.testing.assert_array_equal(g.jj[:g.n_edges], jg.jj[:jg.n_edges])
