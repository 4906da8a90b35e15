"""Parity of the port's foundation ops with the JAX package, fp32.

Same numpy inputs (seeded) go through ``mast3r_slam_tpu.ops`` and
``mast3r_slam_torch.ops``; outputs agree to atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import geometry as jgeo
from mast3r_slam_tpu.ops import image as jimg
from mast3r_slam_tpu.ops import lie_sim3 as jsim3
from mast3r_slam_tpu.ops import robust as jrob
from mast3r_slam_torch.ops import geometry as tgeo
from mast3r_slam_torch.ops import image as timg
from mast3r_slam_torch.ops import lie_sim3 as tsim3
from mast3r_slam_torch.ops import robust as trob

ATOL = 1e-5


def rand_poses(rng, n, scale=0.5):
    xi = (rng.standard_normal((n, 7)) * scale).astype(np.float32)
    return np.asarray(jsim3.exp(jnp.asarray(xi)))


def close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    return {
        "Ta": rand_poses(rng, 16),
        "Tb": rand_poses(rng, 16),
        "X": rng.standard_normal((16, 3)).astype(np.float32),
        # tangents spanning the small-angle and small-sigma branches
        "xi": np.concatenate([
            rng.standard_normal((8, 7)) * 0.5,
            rng.standard_normal((4, 7)) * 1e-4,
            np.concatenate([rng.standard_normal((4, 6)),
                            np.zeros((4, 1))], axis=1),
        ]).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["act", "mul", "inv", "rel", "exp", "retr",
                                  "normalize", "quat_rot_entries"])
def test_lie_sim3(name, data):
    Ta, Tb, X, xi = data["Ta"], data["Tb"], data["X"], data["xi"]
    J = {k: jnp.asarray(v) for k, v in data.items()}
    if name == "act":
        close(jsim3.act(J["Ta"], J["X"]), tsim3.act(T(Ta), T(X)))
    elif name == "mul":
        close(jsim3.mul(J["Ta"], J["Tb"]), tsim3.mul(T(Ta), T(Tb)))
    elif name == "inv":
        close(jsim3.inv(J["Ta"]), tsim3.inv(T(Ta)))
    elif name == "rel":
        close(jsim3.rel(J["Ta"], J["Tb"]), tsim3.rel(T(Ta), T(Tb)))
    elif name == "exp":
        close(jsim3.exp(J["xi"]), tsim3.exp(T(xi)))
    elif name == "retr":
        close(jsim3.retr(J["Ta"][:16], J["xi"][:16]),
              tsim3.retr(T(Ta), T(xi[:16])))
    elif name == "normalize":
        Tn = Ta.copy()
        Tn[:, 3:7] *= 1.3
        close(jsim3.normalize(jnp.asarray(Tn)), tsim3.normalize(T(Tn)))
    elif name == "quat_rot_entries":
        je = jsim3.quat_rot_entries(J["Ta"][:, 3:7])
        te = tsim3.quat_rot_entries(T(Ta[:, 3:7]))
        for jr, tr in zip(je, te):
            for a, b in zip(jr, tr):
                close(a, b)


def test_exp_fp64_matches_jax_fp32_within_float_error(data):
    """The port's exp in float64 against the JAX fp32 exp: the fp32 result
    is within fp32 rounding of the exact map."""
    xi = data["xi"].astype(np.float64)
    t64 = tsim3.exp(torch.from_numpy(xi))
    close(jsim3.exp(jnp.asarray(data["xi"])), t64.float(), atol=1e-5)


def test_pose_recursion_keeps_unit_quaternion(data):
    """retr re-normalises q: a long chain of retractions stays on the
    manifold (lie_sim3.py:212)."""
    Tp = tsim3.identity()
    xi = T(data["xi"][:8]) * 0.1
    for i in range(400):
        Tp = tsim3.retr(Tp, xi[i % 8])
    assert abs(float(torch.linalg.norm(Tp[3:7])) - 1.0) < 1e-6


@pytest.mark.parametrize("k", [1.345, 0.5])
def test_huber(k):
    r = np.linspace(-4, 4, 101).astype(np.float32)
    close(jrob.huber(jnp.asarray(r), k), trob.huber(T(r), k))


@pytest.mark.parametrize("old,new,delta,expect", [
    (np.inf, 1.0, 1.0, False),     # first iteration: no relative test
    (1.0, 0.99999, 1.0, True),     # relative decrease below threshold
    (1.0, 0.5, 1.0, False),
    (1.0, 0.5, 1e-5, True),        # small update
    (0.0, 0.0, 1.0, True),         # zero cost guard
])
def test_check_convergence(old, new, delta, expect):
    d = np.full(7, delta / np.sqrt(7), np.float32)
    j = bool(jrob.check_convergence(1e-3, 1e-3, jnp.float32(old),
                                    jnp.float32(new), jnp.asarray(d)))
    t = bool(trob.check_convergence(1e-3, 1e-3, old,
                                    torch.tensor(new, dtype=torch.float32),
                                    T(d)))
    assert j == t == expect


@pytest.mark.parametrize("seed,scale_spread", [(0, 1.0), (1, 1e3)])
def test_solve_spd_small(seed, scale_spread):
    """Jacobi-prescaled LDL^T solve on SPD systems with dof scales spread
    over orders of magnitude (robust.py:39)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((7, 12)).astype(np.float32)
    D = np.diag(np.geomspace(1.0, scale_spread, 7)).astype(np.float32)
    H = (D @ A @ A.T @ D).astype(np.float32)
    g = rng.standard_normal(7).astype(np.float32)
    xj, okj = jrob.solve_spd_small(jnp.asarray(H), jnp.asarray(g))
    xt, okt = trob.solve_spd_small(T(H), T(g))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(np.asarray(xj), xt.numpy(), rtol=1e-4,
                               atol=ATOL)


def test_solve_spd_small_flags_indefinite():
    H = np.eye(7, dtype=np.float32)
    H[3, 3] = -1.0
    _, okj = jrob.solve_spd_small(jnp.asarray(H), jnp.ones(7))
    _, okt = trob.solve_spd_small(T(H), torch.ones(7))
    assert not bool(okj) and not bool(okt)


def test_point_to_ray_dist():
    X = np.random.default_rng(3).standard_normal((50, 3)).astype(np.float32)
    close(jgeo.point_to_ray_dist(jnp.asarray(X)), tgeo.point_to_ray_dist(T(X)))


@pytest.mark.parametrize("c", [1, 3])
def test_img_gradient(c):
    img = np.random.default_rng(c).standard_normal((2, 9, 13, c)) \
        .astype(np.float32)
    jgx, jgy = jimg.img_gradient(jnp.asarray(img))
    tgx, tgy = timg.img_gradient(T(img))
    close(jgx, tgx)
    close(jgy, tgy)


@pytest.mark.parametrize("hw,size", [((300, 400), 512), ((200, 200), 512),
                                     ((600, 480), 224)])
def test_resize_img(hw, size):
    """Host-side resize and crop of the engine's input (inference.py:392)
    on a float image in [0, 1]: the same pixels and the same shapes."""
    from mast3r_slam_tpu.inference import resize_img as jresize
    from mast3r_slam_torch.inference import resize_img as tresize

    img = np.random.default_rng(sum(hw)).random(hw + (3,)).astype(np.float32)
    j, t = jresize(img, size), tresize(img, size)
    for key in ("img", "true_shape", "unnormalized_img",
                "unnormalized_img_u8"):
        np.testing.assert_array_equal(t[key], np.asarray(j[key]), err_msg=key)
