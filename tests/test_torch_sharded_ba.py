"""The port's edge- and map-sharded BA (``mast3r_slam_torch/parallel``)
against the JAX package's sharded solvers and the port's single-device
solve, and the pipeline with ``local_opt.sharded_ba`` against JAX's.

The port's meshes repeat the one CPU (2 and 8 entries, run one after the
other in this process); JAX's run on the 8 virtual CPU devices of
``tests/conftest.py``.  Inputs are ``tests/test_ba.py``'s identity scene
and perturbation, handed to both sides as numpy arrays.

Tolerances (each the JAX test's own, ``tests/test_sharded_ba.py``):

* sharded poses against the single-device solve (the port's and JAX's):
  atol 2e-4 (measured <= 1.2e-7 against the port's and 2.4e-7 against
  JAX's sharded solve, printed with ``-s``),
  with equal iteration counts (``ba_iters_total`` is compared in the
  drives);
* the pipeline on the 12-frame oracle clip: equal stats, BA iteration
  totals and edges, poses within 2e-4 of JAX's sharded run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import ba as jba
from mast3r_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from mast3r_slam_tpu.parallel.sharded_ba import (
    sharded_gauss_newton as j_sharded,
    sharded_gauss_newton_mapshard as j_mapshard)
from mast3r_slam_torch import device as tdevice
from mast3r_slam_torch.ops import ba
from mast3r_slam_torch.ops import lie_sim3 as tsim3
from mast3r_slam_torch.parallel import sharded_ba
from mast3r_slam_torch.parallel.mesh import make_mesh

from test_ba import H, K, P, W, identity_scene, perturb

SHARD_ATOL = 2e-4
CFG = dict(max_iters=10, chunk_points=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """The identity scene and its perturbed start as numpy arrays, and the
    single-device solves of both packages."""
    T_true, Xs, Cs, ii, jj, idx, vm, Q, ev = identity_scene()
    T0 = perturb(T_true)
    arrays = [np.array(a) for a in (T0, Xs, Cs, ii, jj, idx, vm, Q, ev)]
    jcfg = jba.BAConfig(**CFG)
    Tj, itj, _, _ = jba.gauss_newton(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(K), "ray", (W, H),
        jcfg)
    Tt, itt, _, okt = ba.gauss_newton(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(K), "ray",
        (W, H), ba.BAConfig(**CFG))
    assert okt
    return {"arrays": arrays, "T_true": np.asarray(T_true),
            "jax": (np.asarray(Tj), int(itj)), "port": (Tt.numpy(), itt)}


def _pad(arrays, n_dev, pad_poses):
    """Edges (and, for the map mode, poses and pointmaps) padded to a
    multiple of ``n_dev`` with inert rows, as the JAX test pads them."""
    T0, Xs, Cs, ii, jj, idx, vm, Q, ev = arrays
    E = ii.shape[0]
    pe = (-E) % n_dev

    def padE(a, fill=0):
        return np.concatenate([a, np.full((pe,) + a.shape[1:], fill,
                                          a.dtype)])

    if pad_poses and P % n_dev:
        pp = (-P) % n_dev
        T0 = np.concatenate([T0, np.tile(np.asarray(
            tsim3.identity().numpy())[None], (pp, 1))])
        Xs = np.concatenate([Xs, np.zeros((pp,) + Xs.shape[1:], Xs.dtype)])
        Cs = np.concatenate([Cs, np.zeros((pp,) + Cs.shape[1:], Cs.dtype)])
    return (T0, Xs, Cs, padE(ii), padE(jj), padE(idx), padE(vm, False),
            padE(Q), padE(ev, False))


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("mode", ["edge", "map"])
def test_sharded_solvers_match_jax_and_single_device(scene, mode, n_dev):
    """The port's solver on an ``n_dev``-entry CPU mesh against JAX's
    sharded solver of the same mode on its 8-device mesh, and against the
    port's single-device ``gauss_newton``: poses within 2e-4 and equal
    iteration counts."""
    padded = _pad(scene["arrays"], 8, mode == "map")
    jfn = j_sharded if mode == "edge" else j_mapshard
    Tj, itj, _, okj = jfn(
        jmake_mesh(n_edge=8, n_model=1),
        *(jnp.asarray(a) for a in padded), jnp.asarray(K), "ray", (W, H),
        jba.BAConfig(**CFG), return_stats=True)
    tfn = sharded_ba.sharded_gauss_newton if mode == "edge" else \
        sharded_ba.sharded_gauss_newton_mapshard
    mesh = make_mesh(n_edge=n_dev, devices=["cpu"] * n_dev)
    Tt, itt, _, okt = tfn(
        mesh, *(torch.from_numpy(a) for a in padded), torch.from_numpy(K),
        "ray", (W, H), ba.BAConfig(**CFG), return_stats=True)
    Tt = Tt.numpy()[:P]
    T1, it1 = scene["port"]
    err_jax = float(np.abs(Tt - np.asarray(Tj)[:P]).max())
    err_one = float(np.abs(Tt - T1).max())
    print(f"\n{mode} x{n_dev}: port sharded vs JAX sharded {err_jax:.3g}, "
          f"vs port single-device {err_one:.3g}; iterations {itt} / JAX "
          f"{int(itj)} / single {it1}")
    assert okt and bool(okj)
    assert itt == int(itj) == it1 == scene["jax"][1]
    assert err_jax <= SHARD_ATOL and err_one <= SHARD_ATOL
    assert float(np.abs(Tt - scene["T_true"]).max()) < 1e-3


@pytest.mark.parametrize("mode", ["edge", "map"])
def test_sharded_normal_equations_match_the_single_device_system(scene,
                                                                 mode):
    """The reduced (H, g) of one iteration on a 2-entry mesh against the
    single-device assembly of the same edges (``ops.ba``): only the order
    of the sums differs, relative 1e-6 of the largest entry (measured
    9.5e-9 for H, 9.3e-8 for g)."""
    padded = [torch.from_numpy(a) for a in _pad(scene["arrays"], 2, True)]
    T0, Xs, Cs, ii, jj, idx, vm, Q, ev = padded
    cfg = ba.BAConfig(**CFG)
    Kt = torch.from_numpy(K)
    pre = ba._pregather_edges(Xs, Cs, ii, jj, idx, vm, Q, ev, cfg,
                              min(cfg.chunk_points, idx.shape[1]), (W, H))
    H0, g0 = ba._assemble_dense(
        *ba._accumulate_pre("ray", T0, ii, jj, pre, Kt, (W, H), cfg), ii, jj,
        T0.shape[0], cfg.pin)
    Hs, gs = sharded_ba.sharded_normal_equations(
        make_mesh(2, devices=["cpu"] * 2), *padded, Kt, "ray", (W, H), cfg,
        shard_mode=mode)
    assert float((Hs - H0).abs().max() / H0.abs().max()) <= 1e-6
    assert float((gs - g0).abs().max() / g0.abs().max()) <= 1e-6


def test_sharded_solver_refuses_edges_that_do_not_divide(scene):
    T0, Xs, Cs, ii, jj, idx, vm, Q, ev = (
        torch.from_numpy(a) for a in scene["arrays"])
    mesh = make_mesh(n_edge=3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divide"):
        sharded_ba.sharded_gauss_newton(
            mesh, T0, Xs, Cs, ii[:7], jj[:7], idx[:7], vm[:7], Q[:7], ev[:7],
            torch.from_numpy(K), "ray", (W, H), ba.BAConfig(**CFG))


@pytest.fixture(scope="module")
def clip12(tmp_path_factory):
    """The 12-frame oracle clip of ``tests/test_sharded_ba.py:111``, made by
    the JAX package and loaded by the port."""
    from mast3r_slam_tpu import testing as jtesting
    from mast3r_slam_torch import testing

    d = tmp_path_factory.mktemp("clip12")
    jseq = jtesting.SyntheticSequence(n_frames=12, h=48, w=64, seed=3,
                                      traj_scale=0.5)
    jseq.save(d / "oracle.npz")
    tseq = testing.SyntheticSequence.load(d / "oracle.npz")
    tseq.images = [np.asarray(im) for im in jseq.images]
    return jseq, tseq


@pytest.mark.parametrize("mode", ["edge", "map"])
def test_sharded_ba_in_pipeline_matches_jax(clip12, mode, monkeypatch):
    """``local_opt.sharded_ba`` in the port's ``SLAMSystem`` (the device
    enumerator patched to two CPU entries, so the mesh has 2) against JAX's
    system with the same setting on its 8 devices: equal stats, edges and
    BA iteration totals, poses within 2e-4."""
    from mast3r_slam_tpu import testing as jtesting
    from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
    from mast3r_slam_tpu.utils.config import load_config as jload_config
    from mast3r_slam_torch import testing
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.utils.config import load_config

    jseq, tseq = clip12
    monkeypatch.setattr(tdevice, "local_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 2)

    def cfg_of(load):
        cfg = load("config/eval_no_calib.yaml")
        cfg["dataset"]["img_size"] = 64
        cfg["local_opt"]["sharded_ba"] = mode
        return cfg

    jsys = JaxSLAMSystem(cfg_of(jload_config), jtesting.OracleEngine(jseq),
                         (48, 64), buffer=32)
    tsys = SLAMSystem(cfg_of(load_config),
                      testing.OracleEngine(tseq, device="cpu"), (48, 64),
                      buffer=32, device="cpu")
    for i in range(len(tseq)):
        jsys.process_frame(i, jseq.images[i])
        tsys.process_frame(i, tseq.images[i])
    jsys.terminate()
    tsys.terminate()
    assert jsys.graph.mesh is not None
    assert tsys.graph.mesh.shape == {"edge": 2, "model": 1}
    assert tsys.graph.shard_mode == mode
    assert tsys.stats == jsys.stats and tsys.stats["ba_rounds"] >= 2
    assert tsys.ba_iters_total == jsys.ba_iters_total
    g, jg = tsys.graph, jsys.graph
    np.testing.assert_array_equal(g.ii[:g.n_edges], jg.ii[:jg.n_edges])
    np.testing.assert_array_equal(g.jj[:g.n_edges], jg.jj[:jg.n_edges])
    n = tsys.arena.n_size
    err = float(np.abs(tsys.arena.T_WC[:n].numpy()
                       - np.asarray(jsys.arena.T_WC[:n])).max())
    print(f"\npipeline sharded_ba={mode}: {tsys.stats}, poses {err:.3g} "
          f"from JAX's")
    assert err <= SHARD_ATOL
