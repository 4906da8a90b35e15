"""The port's pointmap bundle adjustment (``mast3r_slam_torch/ops/ba.py``)
against the JAX package's (``mast3r_slam_tpu/ops/ba.py``) on the fixtures of
``tests/test_ba.py``: a 5-camera 16x20 scene whose cameras all see the same
world points (identity matches, exact zero residuals at the truth) and a
tilted plane seen through rounded-pixel projections (the calibrated
residual).  Both sides take the same numpy inputs.

Tolerances, each set from the figure measured on the CPU with a margin of
at most 10x (relative to the largest entry of the compared array):

* subsampling and the pregather are index and copy work: bit for bit;
* residuals and Jacobian rows: the same f32 formulas, relative 5e-6
  (measured <= 1.5e-7 in the (E, C) forms, 6.8e-7 in the SoA rows);
* H and g: relative 1e-5 (measured <= 1.2e-6); the JAX side sums each
  entry over the points on its own, the port with batched products, so
  only summation order differs;
* the assembled system is the blocks moved and added: relative 1e-6
  (measured 1.0e-7);
* the scaled Cholesky solve: relative 5e-5 of |dx| (measured 7.2e-6);
* GN poses after the whole loop: atol 1e-5 (measured <= 1.5e-6), the same
  iteration count.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import ba as jba
from mast3r_slam_tpu.ops import lie_sim3 as jsim3
from mast3r_slam_torch.ops import ba
from mast3r_slam_torch.ops import lie_sim3 as sim3

H, W = 16, 20
HW = H * W
K = np.array([[1.5 * W, 0, W / 2], [0, 1.5 * W, H / 2], [0, 0, 1]],
             np.float32)
P = 5
RES_RTOL = 5e-6
HG_RTOL = 1e-5
ASSEMBLE_RTOL = 1e-6
DX_RTOL = 5e-5
POSE_ATOL = 1e-5


# the JAX functions under one jit each (op-by-op dispatch compiles every op)
_j_pregather = jax.jit(jba._pregather_edges, static_argnums=(8, 9, 10))
_j_accumulate = jax.jit(jba._accumulate_pre, static_argnums=(0, 1, 7, 8))
_j_assemble = jax.jit(jba._assemble_dense, static_argnums=(4, 5))
_j_solve = jax.jit(jba._solve_scaled, static_argnums=(2,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after: the
    suite runs in several worker processes at once, and PyTorch's thread
    pool in each of them then oversubscribes the cores, which slows the
    port's many small ops by more than an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=(0, 7))
def _j_residual(rtype, Tij, Xi, Xj, ind, K, img_wh, cfg):
    jres = jba._RESIDUALS[rtype][0]
    soa = jba._SOA_RESIDUALS[jres](
        Tij, jnp.moveaxis(Xi, -1, 1), jnp.moveaxis(Xj, -1, 1), ind, K,
        img_wh, cfg)
    # None entries cannot leave a jit: mark them with an empty array
    soa = [(jnp.float32(sig), r, [jnp.zeros((0,)) if e is None else
                                  jnp.asarray(e, jnp.float32) for e in J],
            jnp.zeros((0,)) if v is None else v) for sig, r, J, v in soa]
    return jres(Tij, Xi, Xj, ind, K, img_wh, cfg), soa


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt_poses(scale=0.08, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((P, 7)).astype(np.float32) * scale
    xi[0] = 0
    return sim3.exp(_t(xi)).numpy()


def _perturb(T, scale=0.05, seed=5):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((P, 7)).astype(np.float32) * scale
    xi[0] = 0
    return sim3.mul(sim3.exp(_t(xi)), _t(T)).numpy()


def _two_way(pairs):
    ii = [i for i, _ in pairs] + [j for _, j in pairs]
    jj = [j for _, j in pairs] + [i for i, _ in pairs]
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def identity_scene(seed=1):
    """tests/test_ba.py:41, with the weights varied per pixel so every
    gate and weight is exercised."""
    T_true = _gt_poses()
    rng = np.random.default_rng(seed)
    Wp = rng.standard_normal((HW, 3)).astype(np.float32)
    Wp[:, 2] += 4.0
    Xs = sim3.act(sim3.inv(_t(T_true))[:, None], _t(Wp)).numpy()
    Cs = rng.uniform(0.5, 3.0, (P, HW)).astype(np.float32)
    ii, jj = _two_way([(p, p + 1) for p in range(P - 1)] + [(0, P - 1)])
    E = len(ii)
    idx = np.broadcast_to(np.arange(HW, dtype=np.int32), (E, HW)).copy()
    vm = rng.uniform(size=(E, HW)) > 0.1
    Q = rng.uniform(1.0, 6.0, (E, HW)).astype(np.float32)
    ev = np.ones((E,), bool)
    return T_true, Xs, Cs, ii, jj, idx, vm, Q, ev


def plane_scene(seed=0):
    """tests/test_ba.py:126: cameras on a tilted plane, matches from the
    true projection rounded to pixels."""
    T_true = _gt_poses(scale=0.04, seed=seed)
    n = np.array([0.05, -0.08, 1.0])
    n /= np.linalg.norm(n)
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv1 = np.stack([u.ravel(), v.ravel(), np.ones(HW)], 1).astype(np.float64)
    dirs = (np.linalg.inv(K) @ uv1.T).T
    Xs, Xw = [], []
    for p in range(P):
        o = T_true[p][:3]
        d_w = sim3.quat_act(_t(T_true[p][3:7]),
                            _t(dirs.astype(np.float32))).numpy()
        lam = (4.0 - o @ n) / (d_w @ n)
        Xw.append((o[None] + lam[:, None] * d_w).astype(np.float32))
        Xs.append(sim3.act(sim3.inv(_t(T_true[p])), _t(Xw[-1])).numpy())
    ii, jj = _two_way([(p, p + 1) for p in range(P - 1)])
    E = len(ii)
    idx = np.zeros((E, HW), np.int32)
    vm = np.zeros((E, HW), bool)
    for e in range(E):
        Xc = sim3.act(sim3.inv(_t(T_true[ii[e]])), _t(Xw[jj[e]])).numpy()
        uvz = (K @ Xc.T).T
        uu = np.round(uvz[:, 0] / uvz[:, 2]).astype(np.int64)
        vv = np.round(uvz[:, 1] / uvz[:, 2]).astype(np.int64)
        inside = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H) & (Xc[:, 2] > 0)
        idx[e] = np.where(inside, vv * W + uu, 0)
        vm[e] = inside
    return (T_true, np.stack(Xs), np.ones((P, HW), np.float32), ii, jj, idx,
            vm, np.full((E, HW), 4.0, np.float32), np.ones((E,), bool))


SCENES = {"point": identity_scene, "ray": identity_scene,
          "calib": plane_scene}


def _jargs(arrays):
    return [jnp.asarray(a) for a in arrays]


def _targs(arrays):
    return [_t(a) for a in arrays]


def _close(got, ref, rtol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err:.3g} > {rtol:g}"


def test_apply_adj_inv_matches_jax():
    rng = np.random.default_rng(0)
    T = sim3.exp(_t(rng.standard_normal((6, 7)).astype(np.float32) * 0.5)) \
        .numpy()
    v = rng.standard_normal((6, 7, 7)).astype(np.float32)
    ref = jsim3.apply_adj_inv(jnp.asarray(T)[:, None, :], jnp.asarray(v))
    got = sim3.apply_adj_inv(_t(T)[:, None, :], _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _residual_inputs(seed=3, E=3, C=40):
    rng = np.random.default_rng(seed)
    Tij = sim3.exp(_t(rng.standard_normal((E, 7)).astype(np.float32) * 0.3)) \
        .numpy()
    Xi = rng.standard_normal((E, C, 3)).astype(np.float32)
    Xj = rng.standard_normal((E, C, 3)).astype(np.float32)
    Xi[..., 2] += 4.0
    Xj[..., 2] += 4.0
    Xi[0, :3, 2] = -1.0        # behind the camera: calib validity
    ind = rng.integers(0, HW, (E, C)).astype(np.int32)
    return Tij, Xi, Xj, ind


@pytest.mark.parametrize("rtype", ["point", "ray", "calib"])
def test_residuals_and_jacobian_rows_match_jax(rtype):
    """The (E, C) residual builders and their SoA row forms: errors,
    Jacobian rows and validity; the SoA rows equal the (E, C) ones."""
    Tij, Xi, Xj, ind = _residual_inputs()
    R = jba._RESIDUALS[rtype][1]
    cfg, jcfg = ba.BAConfig(), jba.BAConfig()
    jout, jrows = _j_residual(rtype, *_jargs([Tij, Xi, Xj, ind, K]), (W, H),
                              jcfg)
    tres, tR = ba._RESIDUALS[rtype]
    assert tR == R
    tout = tres(_t(Tij), _t(Xi), _t(Xj), _t(ind), _t(K), (W, H), cfg)
    for name, got, ref in zip(("err", "J", "valid", "sig"), tout, jout):
        if name == "valid":
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            _close(got.numpy(), ref, RES_RTOL, f"{rtype} {name}")

    # SoA rows: the same quantities with points on the last axis
    trows = ba._SOA_RESIDUALS[rtype](
        _t(Tij), _t(Xi).transpose(1, 2), _t(Xj).transpose(1, 2), _t(ind),
        _t(K), (W, H), cfg)
    assert len(trows) == len(jrows) == R
    like = torch.zeros(Xi.shape[:2])
    sig, r, J, valid = ba.soa_rows_dense(trows, like)
    for k, (jsig, jr, jJ, jv) in enumerate(jrows):
        assert abs(float(sig[k]) - float(jsig)) <= 1e-6 * abs(float(jsig))
        _close(r[:, k].numpy(), jr, RES_RTOL, f"{rtype} SoA r{k}")
        for m in range(7):
            ref = np.broadcast_to(np.asarray(jJ[m]), Xi.shape[:2]) \
                if jJ[m].size else np.zeros(Xi.shape[:2])
            np.testing.assert_allclose(J[:, k, m].numpy(), ref, rtol=RES_RTOL,
                                       atol=RES_RTOL * 10,
                                       err_msg=f"{rtype} J[{k}][{m}]")
        if not jv.size:
            assert valid is None
        else:
            np.testing.assert_array_equal(valid[:, k].numpy(), np.asarray(jv))
    # the SoA rows are the (E, C) residual's rows
    err, Jl = tout[0], tout[1]
    _close(r.transpose(1, 2).numpy(), err.numpy(), RES_RTOL, "SoA vs AoS r")
    _close(J.permute(0, 3, 1, 2).numpy(), Jl.numpy(), RES_RTOL,
           "SoA vs AoS J")


@pytest.mark.parametrize("s,img_wh", [(1, (W, H)), (2, (W, H)),
                                      (4, (W, H)), (3, (W, H)), (4, None)],
                         ids=["s1", "s2", "s4", "s3-flat", "s4-no-wh"])
def test_subsample_points_bitwise(s, img_wh):
    """The 2D-balanced (sv, su) grid, and the flat stride with its warning
    where the factors do not divide (h, w) or no size is given, on both
    sides."""
    a = np.arange(2 * HW * 3, dtype=np.float32).reshape(2, HW, 3)
    flat = s > 1 and (img_wh is None or s == 3)
    jba._flat_fallback_warned.clear()
    ba._flat_fallback_warned.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = np.asarray(jba.subsample_points(jnp.asarray(a), s, img_wh))
        got = ba.subsample_points(_t(a), s, img_wh).numpy()
    np.testing.assert_array_equal(got, ref)
    assert sum("flat [:, ::s] stride" in str(w.message)
               for w in caught) == (2 if flat else 0)
    if s == 4 and not flat:      # (::2, ::2): the even pixels
        np.testing.assert_array_equal(
            got[0, :, 0], a[0].reshape(H, W, 3)[::2, ::2, 0].ravel())


@pytest.mark.parametrize("s", [1, 4])
def test_pregather_edges_bitwise(s):
    """Gathered points, weights and indices, padded to the chunk: equal bit
    for bit, padded (edge_valid False) edges included."""
    T, Xs, Cs, ii, jj, idx, vm, Q, ev = identity_scene()
    ev = ev.copy()
    ev[2] = False
    cfg = ba.BAConfig(points_subsample=s, Q_conf=2.0, C_conf=1.0)
    jcfg = jba.BAConfig(points_subsample=s, Q_conf=2.0, C_conf=1.0)
    C = 48
    ref = _j_pregather(*_jargs([Xs, Cs, ii, jj, idx, vm, Q, ev]),
                               jcfg, C, (W, H))
    got = ba._pregather_edges(*_targs([Xs, Cs, ii, jj, idx, vm, Q, ev]),
                              cfg, C, (W, H))
    for name in ba.EdgeData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.sqw.shape[1] % C == 0 and not got.sqw[2].any()


@pytest.mark.parametrize("rtype", ["point", "ray", "calib"])
def test_accumulate_pre_matches_jax(rtype):
    """H (E, 14, 14) and g (E, 14) at a perturbed pose, over several point
    chunks and, with a small pass budget, several passes."""
    T, Xs, Cs, ii, jj, idx, vm, Q, ev = SCENES[rtype]()
    T0 = _perturb(T)
    cfg = ba.BAConfig(chunk_points=64)
    jcfg = jba.BAConfig(chunk_points=64)
    pre_j = _j_pregather(*_jargs([Xs, Cs, ii, jj, idx, vm, Q, ev]),
                                 jcfg, 64, (W, H))
    jres, R = jba._RESIDUALS[rtype]
    Hj, gj = _j_accumulate(jres, R, jnp.asarray(T0), jnp.asarray(ii),
                                 jnp.asarray(jj), pre_j, jnp.asarray(K),
                                 (W, H), jcfg)
    pre_t = ba._pregather_edges(*_targs([Xs, Cs, ii, jj, idx, vm, Q, ev]),
                                cfg, 64, (W, H))
    for budget in (ba._PASS_ELEMENTS, 64 * 7 * 4 * len(ii)):
        old, ba._PASS_ELEMENTS = ba._PASS_ELEMENTS, budget
        try:
            Ht, gt = ba._accumulate_pre(rtype, _t(T0), _t(ii), _t(jj), pre_t,
                                        _t(K), (W, H), cfg)
        finally:
            ba._PASS_ELEMENTS = old
        for e in range(len(ii)):
            _close(Ht[e].numpy(), np.asarray(Hj[e]), HG_RTOL, f"H edge {e}")
            _close(gt[e].numpy(), np.asarray(gj[e]), HG_RTOL, f"g edge {e}")


@pytest.mark.parametrize("pin", [1, 2])
def test_assemble_dense_matches_jax(pin):
    """Blocks of free and pinned endpoints, an edge between two pinned
    poses and repeated pairs; the port's incidence products give JAX's
    scatter-added system."""
    rng = np.random.default_rng(pin)
    ii = np.array([0, 1, 2, 3, 0, 1, 4, 2], np.int32)
    jj = np.array([1, 2, 3, 4, 4, 0, 2, 3], np.int32)
    Hs = rng.standard_normal((len(ii), 14, 14)).astype(np.float32)
    gs = rng.standard_normal((len(ii), 14)).astype(np.float32)
    Hr, gr = _j_assemble(jnp.asarray(Hs), jnp.asarray(gs),
                                 jnp.asarray(ii), jnp.asarray(jj), P, pin)
    Ht, gt = ba._assemble_dense(_t(Hs), _t(gs), _t(ii), _t(jj), P, pin)
    assert Ht.shape == (7 * (P - pin),) * 2
    _close(Ht.numpy(), Hr, ASSEMBLE_RTOL, "H")
    _close(gt.numpy(), gr, ASSEMBLE_RTOL, "g")


def test_solve_scaled_matches_jax():
    """A system of the identity scene with two empty (padded) pose rows,
    and a system that is not positive definite: ok False and dx 0 on both
    sides."""
    T, Xs, Cs, ii, jj, idx, vm, Q, ev = identity_scene()
    T0 = _perturb(T)
    jcfg = jba.BAConfig(chunk_points=64)
    jres, R = jba._RESIDUALS["ray"]
    Ta, Xa, Ca, ia, ja, idxa, vma, Qa, eva, Ka = _jargs(
        [T0, Xs, Cs, ii, jj, idx, vm, Q, ev, K])
    pre = _j_pregather(Xa, Ca, ia, ja, idxa, vma, Qa, eva, jcfg, 64, (W, H))
    Hs, gs = _j_accumulate(jres, R, Ta, ia, ja, pre, Ka, (W, H), jcfg)
    Hm, gm = _j_assemble(Hs, gs, jnp.asarray(ii), jnp.asarray(jj),
                                 P + 2, 1)
    Hm, gm = np.asarray(Hm), np.asarray(gm)
    assert not Hm[-14:].any()
    dxr, okr = _j_solve(jnp.asarray(Hm), jnp.asarray(gm), 1e-6)
    dxt, okt = ba._solve_scaled(_t(Hm), _t(gm), 1e-6)
    assert bool(okr) and bool(okt)
    _close(dxt.numpy(), dxr, DX_RTOL, "dx")
    assert not dxt[-14:].any()

    bad = Hm.copy()
    bad[3, 4] = bad[4, 3] = 2.0 * np.sqrt(bad[3, 3] * bad[4, 4])
    dxr, okr = _j_solve(jnp.asarray(bad), jnp.asarray(gm), 1e-6)
    dxt, okt = ba._solve_scaled(_t(bad), _t(gm), 1e-6)
    assert not bool(okr) and not bool(okt)
    assert not np.asarray(dxr).any() and not dxt.any()


@pytest.mark.parametrize("rtype,max_iters", [("point", 20), ("ray", 20),
                                             ("calib", 20), ("ray", 3)])
def test_gauss_newton_matches_jax(rtype, max_iters):
    """The whole solve from a perturbed start: the same iteration count and
    ok, poses within atol 1e-5, the pinned pose untouched; the ray and
    point solves recover the truth (tests/test_ba.py:71, 86)."""
    T, Xs, Cs, ii, jj, idx, vm, Q, ev = SCENES[rtype]()
    T0 = _perturb(T, scale=0.02 if rtype == "calib" else 0.05)
    cfg = ba.BAConfig(max_iters=max_iters, chunk_points=128)
    jcfg = jba.BAConfig(max_iters=max_iters, chunk_points=128)
    Tj, itj, _, okj = jba.gauss_newton(
        *_jargs([T0, Xs, Cs, ii, jj, idx, vm, Q, ev, K]), rtype, (W, H), jcfg)
    Tt, itt, delta, okt = ba.gauss_newton(
        *_targs([T0, Xs, Cs, ii, jj, idx, vm, Q, ev, K]), rtype, (W, H), cfg)
    assert itt == int(itj) and okt == bool(okj) and okt
    assert delta.dim() == 0
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=POSE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(Tt[0].numpy(), T0[0])
    if rtype != "calib" and max_iters == 20:
        assert np.abs(Tt.numpy() - T).max() < 1e-3


def test_gauss_newton_edge_padding_is_inert():
    """tests/test_ba.py:98: padded (edge_valid False) edges with garbage
    matches and high confidence change nothing."""
    T, Xs, Cs, ii, jj, idx, vm, Q, ev = identity_scene()
    T0 = _perturb(T)
    cfg = ba.BAConfig(max_iters=10, chunk_points=128)
    pad = 4
    padded = [T0, Xs, Cs, np.concatenate([ii, np.zeros(pad, np.int32)]),
              np.concatenate([jj, np.ones(pad, np.int32)]),
              np.concatenate([idx, idx[:pad] * 0]),
              np.concatenate([vm, np.ones((pad, HW), bool)]),
              np.concatenate([Q, np.full((pad, HW), 9.0, np.float32)]),
              np.concatenate([ev, np.zeros(pad, bool)]), K]
    Ta, ita, _, _ = ba.gauss_newton(
        *_targs([T0, Xs, Cs, ii, jj, idx, vm, Q, ev, K]), "ray", (W, H), cfg)
    Tb, itb, _, _ = ba.gauss_newton(*_targs(padded), "ray", (W, H), cfg)
    assert ita == itb
    np.testing.assert_array_equal(Ta.numpy(), Tb.numpy())
