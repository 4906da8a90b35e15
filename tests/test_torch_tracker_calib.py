"""The calibrated and the reference-exact tracker bodies against the JAX
package, on the fixtures of ``tests/test_tracker.py`` (a 24x32 smooth scene
seen through a pinhole camera, a known relative pose).

Same numpy inputs go to both packages.  ``project_calib`` and its Jacobian
agree to atol 1e-5 (f32, a handful of operations per entry).  The solves run
the same number of GN iterations and their poses agree to atol 1e-4: each
iteration's 7x7 system is reduced from ~3,000 f32 rows in another order
(XLA's fused sums against one matrix product here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import tracker as jtrk
from mast3r_slam_tpu.frame import make_empty_frame
from mast3r_slam_tpu.ops import geometry as jgeo
from mast3r_slam_tpu.ops import lie_sim3 as jsim3
from mast3r_slam_torch import tracker as ttrk
from mast3r_slam_torch.frame import Frame
from mast3r_slam_torch.ops import geometry as tgeo
from mast3r_slam_torch.utils.config import apply_reference_exact, load_config

H, W = 24, 32
HW = H * W
K = np.array([[2.0 * W, 0, W / 2], [0, 2.0 * W, H / 2], [0, 0, 1]],
             np.float32)
ATOL = 1e-5
POSE_ATOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def scene_points():
    uv = jgeo.get_pixel_coords(1, (H, W))
    u, v = uv[..., 0], uv[..., 1]
    z = 2.0 + 0.3 * jnp.sin(2 * jnp.pi * u / W) * jnp.cos(2 * jnp.pi * v / H)
    return np.asarray(jgeo.backproject(uv, z[..., None], jnp.asarray(K))
                      .reshape(HW, 3))


def rand_pose(scale, seed):
    xi = np.random.default_rng(seed).standard_normal(7) * scale
    return np.asarray(jsim3.exp(jnp.asarray(xi, jnp.float32)))


def _problem(seed, scale=0.05, outliers=0.0):
    Xk = scene_points()
    T_true = rand_pose(scale, seed)
    Xf = np.array(jsim3.act(jsim3.inv(jnp.asarray(T_true)), jnp.asarray(Xk)))
    if outliers:
        rng = np.random.default_rng(seed + 100)
        mask = rng.random(HW) < outliers
        Xf[mask] += rng.standard_normal((mask.sum(), 3)).astype(np.float32)
    Q = np.full((HW, 1), 4.0, np.float32)
    valid = np.ones((HW, 1), np.float32)
    return Xf, Xk, Q, valid, T_true


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    jrd, jJ = jgeo.point_to_ray_dist(jnp.asarray(X), jacobian=True)
    trd, tJ = tgeo.point_to_ray_dist(T(X), jacobian=True)
    np.testing.assert_allclose(trd.numpy(), np.asarray(jrd), atol=ATOL)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=ATOL)
    np.testing.assert_allclose(tgeo.skew_sym(T(X)).numpy(),
                               np.asarray(jgeo.skew_sym(jnp.asarray(X))))
    np.testing.assert_array_equal(
        tgeo.get_pixel_coords(2, (H, W)).numpy(),
        np.asarray(jgeo.get_pixel_coords(2, (H, W))))
    Xs = rng.standard_normal((2, HW, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.constrain_points_to_ray((H, W), T(Xs), T(K)).numpy(),
        np.asarray(jgeo.constrain_points_to_ray((H, W), jnp.asarray(Xs),
                                                jnp.asarray(K))), atol=ATOL)
    assert [float(x) for x in tgeo.decompose_K(T(K))] == \
        [float(x) for x in jgeo.decompose_K(jnp.asarray(K))]


@pytest.mark.parametrize("border,z_eps", [(0, 0.0), (-10, 1e-6), (3, 0.5)])
def test_project_calib_matches_jax(border, z_eps):
    """Pixels, log-depth, validity and the Jacobian, with points behind the
    camera and outside the image among the inputs."""
    rng = np.random.default_rng(1)
    P = scene_points() + rng.standard_normal((HW, 3)).astype(np.float32) * 0.5
    P[:20, 2] *= -1.0
    P[20:30, 2] = 0.0
    jpz, jJ, jv = jgeo.project_calib(jnp.asarray(P), jnp.asarray(K), (H, W),
                                     jacobian=True, border=border,
                                     z_eps=z_eps)
    tpz, tJ, tv = tgeo.project_calib(T(P), T(K), (H, W), jacobian=True,
                                     border=border, z_eps=z_eps)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < tv.float().mean() < 1
    np.testing.assert_allclose(tpz.numpy(), np.asarray(jpz), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=ATOL,
                               rtol=1e-6)
    tpz2, tv2 = tgeo.project_calib(T(P), T(K), (H, W), border=border,
                                   z_eps=z_eps)
    assert torch.equal(tpz2, tpz) and torch.equal(tv2, tv)


def _cfgs(path, reference_exact=False, **tracking):
    cfg = load_config(path)
    if reference_exact:
        cfg = apply_reference_exact(cfg)
    cfg["tracking"].update(tracking)
    return (jtrk.TrackerConfig.from_config(cfg),
            ttrk.TrackerConfig.from_config(cfg))


@pytest.mark.parametrize("path", ["config/base.yaml",
                                  "config/eval_calib.yaml",
                                  "config/eval_no_calib.yaml"])
@pytest.mark.parametrize("reference_exact", [False, True])
def test_tracker_config_of_every_shipped_config(path, reference_exact):
    jcfg, tcfg = _cfgs(path, reference_exact)
    assert jcfg._asdict() == tcfg._asdict()
    assert tcfg.joint_ray_huber == (not reference_exact)
    assert tcfg.use_calib == ("eval_calib" in path)


@pytest.mark.parametrize("seed,outliers", [(1, 0.0), (4, 0.05)])
def test_opt_pose_calib_sim3_matches_jax(seed, outliers):
    Xf, Xk, Q, valid, T_true = _problem(seed, scale=0.03, outliers=outliers)
    jcfg, tcfg = _cfgs("config/eval_calib.yaml")
    assert tcfg.use_calib and tcfg.pixel_border == -10
    uv = np.asarray(jgeo.get_pixel_coords(1, (H, W))).reshape(-1, 2)
    meas = np.concatenate([uv, np.log(Xk[:, 2:3])], -1).astype(np.float32)
    vmeas = Xk[:, 2:3] > tcfg.depth_eps
    T0 = np.array(jsim3.identity())
    Tj, okj, itj = jtrk.opt_pose_calib_sim3(
        *map(jnp.asarray, (Xf, Xk, T0, Q, valid, meas, vmeas, K)), (H, W),
        jcfg)
    Tt, okt, itt = ttrk.opt_pose_calib_sim3(
        *map(T, (Xf, Xk, T0, Q, valid, meas, vmeas, K)), (H, W), tcfg)
    assert bool(okj) and okt
    assert int(itj) == itt
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=POSE_ATOL,
                               rtol=0)
    if not outliers:
        np.testing.assert_allclose(Tt.numpy(), T_true, atol=1e-3, rtol=0)


@pytest.mark.parametrize("seed,outliers", [(2, 0.0), (3, 0.05)])
def test_per_component_huber_solve_matches_jax(seed, outliers):
    """``joint_ray_huber: False``, the reference-exact body."""
    Xf, Xk, Q, valid, T_true = _problem(seed, outliers=outliers)
    jcfg, tcfg = _cfgs("config/base.yaml", reference_exact=True)
    assert not tcfg.joint_ray_huber
    T0 = np.array(jsim3.identity())
    Tj, okj, itj = jtrk.opt_pose_ray_dist_sim3(
        *map(jnp.asarray, (Xf, Xk, T0, Q, valid)), jcfg)
    Tt, okt, itt = ttrk.opt_pose_ray_dist_sim3(
        *map(T, (Xf, Xk, T0, Q, valid)), tcfg)
    assert bool(okj) and okt
    assert int(itj) == itt
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=POSE_ATOL,
                               rtol=0)
    if not outliers:
        np.testing.assert_allclose(Tt.numpy(), T_true, atol=1e-4, rtol=0)


class _FakeEngine:
    """Oracle decode + match of ``tests/test_tracker.py``: the frame sees
    the keyframe's points in its own camera; matches are the identity."""

    def __init__(self, Xff, as_torch):
        self.conv = T if as_torch else jnp.asarray
        self.Xff = Xff

    def match_asymmetric(self, f1, p1, f2, p2, idx_init):
        c = self.conv
        ones = np.ones((1, HW, 1), np.float32)
        return (c(np.arange(HW)[None]), c(np.ones((1, HW, 1), bool)),
                c(self.Xff[None]), c(10 * ones), c(4 * ones),
                c(self.Xff[None]), c(10 * ones), c(4 * ones))


def _torch_frame(X, C, n):
    return Frame(
        frame_id=torch.zeros((), dtype=torch.int32),
        uimg=torch.zeros((H, W, 3), dtype=torch.uint8),
        T_WC=T(np.array(jsim3.identity())), X_canon=T(X), C=T(C),
        feat=torch.zeros((6, 8)), pos=torch.zeros((6, 2), dtype=torch.int64),
        N=torch.tensor(n, dtype=torch.int32),
        N_updates=torch.tensor(n, dtype=torch.int32),
        score=torch.zeros(()))


@pytest.mark.parametrize("path,tracking", [
    ("config/base.yaml", {"point_subsample": 2}),
    ("config/eval_calib.yaml", {}),
    ("config/eval_calib.yaml", {"point_subsample": 2}),
], ids=["subsample2", "calib", "calib_subsample2"])
def test_track_step_matches_jax(path, tracking):
    """The whole tracking step under ``point_subsample 2`` and in the
    calibrated mode: frame pose, fused keyframe pointmap, match fraction
    and keyframe metric."""
    Xf, Xk, Q, valid, T_true = _problem(2)
    jcfg, tcfg = _cfgs(path, **tracking)
    zeros3, zeros1 = np.zeros((HW, 3), np.float32), np.zeros((HW, 1),
                                                             np.float32)
    C = np.full((HW, 1), 10.0, np.float32)

    jkf = make_empty_frame(H, W, 6, 8).replace(
        X_canon=jnp.asarray(Xk), C=jnp.asarray(C), N=jnp.ones((), jnp.int32),
        N_updates=jnp.ones((), jnp.int32))
    jres = jtrk.track_step(
        _FakeEngine(Xf, False).match_asymmetric, make_empty_frame(H, W, 6, 8),
        jkf, jnp.arange(HW, dtype=jnp.int32)[None], jnp.asarray(K), jcfg)
    tres = ttrk.track_step(
        _FakeEngine(Xf, True), _torch_frame(zeros3, zeros1, 0),
        _torch_frame(Xk, C, 1), torch.arange(HW)[None], tcfg, K=T(K))
    assert bool(jres.ok) and tres.ok
    assert int(jres.gn_iters) == tres.gn_iters
    np.testing.assert_allclose(tres.frame.T_WC.numpy(),
                               np.asarray(jres.frame.T_WC), atol=POSE_ATOL,
                               rtol=0)
    if not tcfg.use_calib:
        # (identity matches of points that are not on the frame's own pixel
        # rays carry no calibrated pose: there only the parity is held; the
        # oracle drive of test_torch_drive.py recovers calibrated poses)
        np.testing.assert_allclose(tres.frame.T_WC.numpy(), T_true,
                                   atol=1e-3, rtol=0)
    np.testing.assert_allclose(tres.keyframe.X_canon.numpy(),
                               np.asarray(jres.keyframe.X_canon), atol=1e-3,
                               rtol=0)
    assert float(tres.match_frac) == float(jres.match_frac)
    assert float(tres.new_kf_metric) == float(jres.new_kf_metric)
