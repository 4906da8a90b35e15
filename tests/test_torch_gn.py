"""GN accumulation and the ray+distance pose solve against the JAX package.

``gn_accumulate_plain`` is held against the JAX Pallas kernel run in
interpret mode (rtol 1e-4, relative to each output's largest entry), and
the port's ``opt_pose_ray_dist_sim3`` against the JAX solve, which takes
the same kernel in interpret mode off the TPU (pose atol 1e-4).  The CUDA
kernel is held against the plain version on the card in
``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import tracker as jtrk
from mast3r_slam_tpu.ops import gn_pallas as jgn
from mast3r_slam_tpu.ops import lie_sim3 as jsim3
from mast3r_slam_torch import testing
from mast3r_slam_torch import tracker as ttrk
from mast3r_slam_torch.ops import gn as tgn
from mast3r_slam_torch.ops import lie_sim3 as tsim3
from mast3r_slam_torch.utils.config import load_config

RTOL = 1e-4
POSE_ATOL = 1e-4


def _problem(n, seed, noise=0.01, outliers=0.0):
    """Matched points of a keyframe (Xk) and a frame (Xf) under a known
    Sim(3), with confidences, a validity mask and optional gross outliers."""
    rng = np.random.default_rng(seed)
    Xk = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    Xk[:, 2] += 3.0
    xi = (rng.standard_normal(7) * 0.03).astype(np.float32)
    T_true = np.asarray(jsim3.exp(jnp.asarray(xi)))
    Xf = np.asarray(jsim3.act(jsim3.inv(jnp.asarray(T_true)),
                              jnp.asarray(Xk)))
    Xf = Xf + rng.standard_normal((n, 3)).astype(np.float32) * noise
    bad = rng.random(n) < outliers
    Xf[bad] += rng.standard_normal((int(bad.sum()), 3)).astype(np.float32)
    Q = rng.uniform(1.0, 4.0, (n, 1)).astype(np.float32)
    valid = (rng.random((n, 1)) < 0.9).astype(np.float32)
    return Xf.astype(np.float32), Xk, Q, valid, T_true


def _point_data(Xf, Xk, Q, valid, sigma_ray=0.003, sigma_dist=10.0):
    vq = (valid * np.sqrt(Q))[:, 0]
    dk = np.sqrt(np.maximum((Xk * Xk).sum(-1), 1e-24))
    rd_k_t = np.concatenate([Xk.T / dk[None], dk[None]]).astype(np.float32)
    return (Xf, rd_k_t, (vq / sigma_ray).astype(np.float32),
            (vq / sigma_dist).astype(np.float32))


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rtol * max(np.abs(j).max(), 1e-12))


@pytest.mark.parametrize("n,outliers,pose_scale", [
    (1000, 0.0, 0.0),      # at the identity
    (3000, 0.2, 0.05),     # Huber-clipped outliers, a pose off the identity
    (777, 0.0, 0.3),       # ragged n (not a multiple of 128)
])
def test_gn_accumulate_plain_matches_pallas_interpret(n, outliers,
                                                      pose_scale):
    Xf, Xk, Q, valid, _ = _problem(n, seed=n, outliers=outliers)
    args = _point_data(Xf, Xk, Q, valid)
    rng = np.random.default_rng(1)
    T = np.array(jsim3.exp(jnp.asarray(
        (rng.standard_normal(7) * pose_scale).astype(np.float32))))
    Hj, gj, cj = jgn.gn_accumulate(
        jgn.GNPointData(*map(jnp.asarray, args)), jnp.asarray(T), 1.345,
        interpret=True)
    pre = tgn.GNPointData(*map(torch.from_numpy, args))
    Ht, gt, ct = tgn.gn_accumulate_plain(pre, torch.from_numpy(T), 1.345)
    _close(Ht, Hj)
    _close(gt, gj)
    _close(ct, cj)


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors ``gn_accumulate`` is the plain version and counts no
    kernel launch."""
    Xf, Xk, Q, valid, _ = _problem(500, seed=3)
    pre = tgn.GNPointData(*map(torch.from_numpy,
                               _point_data(Xf, Xk, Q, valid)))
    T = tsim3.identity()
    before = tgn.gn_sums.launches
    out = tgn.gn_accumulate(pre, T, 1.345)
    assert tgn.gn_sums.launches == before
    for a, b in zip(out, tgn.gn_accumulate_plain(pre, T, 1.345)):
        assert torch.equal(a, b)


def _fault_free(scal, sums):
    return sums


def _zero_h_ss(scal, sums):
    return sums.index_fill(0, torch.tensor([18]), 0.0)


def _transposed_r(scal, sums):
    return scal[[0, 3, 6, 1, 4, 7, 2, 5, 8, 9, 10, 11, 12]]


def _unit_scale(scal, sums):
    return scal.index_fill(0, torch.tensor([12]), 1.0)


def _t_as_s(scal, sums):
    return scal[[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 11]]


@pytest.mark.parametrize("fault", [_fault_free, _zero_h_ss, _transposed_r,
                                   _unit_scale, _t_as_s])
def test_gn_sums_check_catches_planted_faults(fault):
    """The card's check of kernel B (``testing.gn_sums_check``) passes the
    plain sums in f64 and fails a kernel with one planted fault: a zeroed
    H_ss, R read transposed, the scale read as 1, or t_z and s swapped.  At
    the identity pose, or held to the largest entry of H, several of these
    would pass."""
    pre, T = testing.gn_problem(196608, 196608)
    scal = tgn.rot_scalars(T)
    terms = tgn.gn_terms_plain(pre.pts, scal, 1.345)
    if fault is _fault_free:
        sums = terms.double().sum(dim=1).float()
    elif fault is _zero_h_ss:
        sums = fault(scal, terms.sum(dim=1))
    else:
        sums = tgn.gn_sums_plain(pre.pts, fault(scal, None), 1.345)
    err, tol = testing.gn_sums_check(sums, terms)
    assert bool((err <= tol).all()) == (fault is _fault_free)


def _tracker_configs():
    cfg = load_config("config/base.yaml")
    return (jtrk.TrackerConfig.from_config(cfg),
            ttrk.TrackerConfig.from_config(cfg))


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.1)])
def test_opt_pose_ray_dist_sim3_matches_jax(seed, outliers):
    Xf, Xk, Q, valid, T_true = _problem(4000, seed, noise=0.002,
                                        outliers=outliers)
    jcfg, tcfg = _tracker_configs()
    assert jcfg.joint_ray_huber and not jcfg.use_calib
    T0 = np.array(jsim3.identity())
    Tj, okj, itj = jtrk.opt_pose_ray_dist_sim3(
        *map(jnp.asarray, (Xf, Xk, T0, Q, valid)), jcfg)
    Tt, okt, itt = ttrk.opt_pose_ray_dist_sim3(
        *map(torch.from_numpy, (Xf, Xk, T0, Q, valid)), tcfg)
    assert bool(okj) and okt
    assert int(itj) == itt
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=POSE_ATOL,
                               rtol=0)
    if not outliers:   # the solve found the pose the points were made with
        np.testing.assert_allclose(Tt.numpy(), T_true, atol=5e-3, rtol=0)


@pytest.mark.parametrize("block,knob,value", [
    ("tracking", "joint_ray_huber", False),
    ("tracking", "point_subsample", 2),
    (None, "use_calib", True),
])
def test_tracker_config_refuses_unported_knobs(block, knob, value):
    """No knob of the tracker is left unported: each value that the first
    slice of the port refused is now taken and stored as the JAX
    ``TrackerConfig`` stores it."""
    cfg = load_config("config/base.yaml")
    (cfg[block] if block else cfg)[knob] = value
    tcfg = ttrk.TrackerConfig.from_config(cfg)
    assert getattr(tcfg, knob) == value
    assert tcfg._asdict() == jtrk.TrackerConfig.from_config(cfg)._asdict()
