"""The port's factor graph (``mast3r_slam_torch/global_opt.py``) against the
JAX package's (``mast3r_slam_tpu/global_opt.py``).

Both sides build the same 4-keyframe arena: a rendered 32x48 oracle clip
(``SyntheticSequence``, true-projection matches through each package's
``OracleEngine``) for the symmetric edges and solves, and the fixtures of
``tests/test_global_opt.py`` (identity matches) for the stub engines.

Tolerances: the edge store is integer and copy work plus one exactly
rounded square root: ``ii``/``jj``, indices, masks and weights are equal bit
for bit.  Solved poses: atol 4e-6 (measured <= 4.5e-7 over these solves;
the port sums the normal equations in another order), ``upd`` and the
iteration count equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import frame as jfr
from mast3r_slam_tpu import global_opt as jgo
from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_torch import frame as tfr
from mast3r_slam_torch import global_opt as go
from mast3r_slam_torch import testing
from mast3r_slam_torch.ops import lie_sim3 as sim3
from mast3r_slam_torch.ops import matching
from mast3r_slam_torch.utils.config import load_config

H, W = 32, 48
HW = H * W
P = 4
POSE_ATOL = 4e-6
STORE = ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
         "Q_ii2jj", "Q_jj2ii")


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


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """The clip rendered by the port and saved; the JAX package loads the
    same geometry (``tests/test_torch_drive.py`` holds the two renderers
    to each other)."""
    d = tmp_path_factory.mktemp("seq")
    testing.SyntheticSequence(n_frames=P, h=H, w=W, seed=1,
                              traj_scale=0.3).save(d / "o.npz")
    return (jtesting.SyntheticSequence.load(d / "o.npz"),
            testing.SyntheticSequence.load(d / "o.npz"))


def _cfg(**local_opt):
    cfg = load_config("config/eval_no_calib.yaml")
    cfg["local_opt"].update({"max_edges": 8, "chunk_points": 256,
                             **local_opt})
    return cfg


def _poses(seq, scale=0.03, seed=2):
    """The true poses with the non-pinned ones perturbed."""
    xi = np.random.default_rng(seed).standard_normal((P, 7)).astype(
        np.float32) * scale
    xi[0] = 0
    return sim3.mul(sim3.exp(torch.from_numpy(xi)),
                    torch.as_tensor(np.asarray(seq.T_WC))).numpy()


def _arenas(X, T, feat, N_updates=None):
    """The same 4-keyframe arena on both sides: pointmaps X (P, hw, 3),
    poses T (P, 8), encoder features feat (P, 16, 32)."""
    nupd = np.ones(P, np.int32) if N_updates is None else N_updates
    ja = jfr.make_arena(8, H, W, 16, 32).replace(
        X=jnp.zeros((8, HW, 3)).at[:P].set(X),
        C=jnp.zeros((8, HW, 1)).at[:P].set(10.0),
        N=jnp.zeros(8, jnp.int32).at[:P].set(1),
        N_updates=jnp.zeros(8, jnp.int32).at[:P].set(nupd),
        T_WC=jfr.make_arena(8, 1, 1, 1, 1).T_WC.at[:P].set(T),
        feat=jnp.zeros((8, 16, 32)).at[:P].set(feat),
        n_size=jnp.asarray(P, jnp.int32))
    ta = tfr.make_arena(8, H, W, 16, 32, "cpu")
    ta.X[:P] = torch.from_numpy(np.asarray(X))
    ta.C[:P] = 10.0
    ta.N[:P] = 1
    ta.N_updates[:P] = torch.from_numpy(nupd)
    ta.T_WC[:P] = torch.from_numpy(np.asarray(T))
    ta.feat[:P] = torch.from_numpy(np.asarray(feat))
    ta.n_size = P
    return ja, ta


def _oracle_arenas(seqs):
    jseq, tseq = seqs
    jeng = jtesting.OracleEngine(jseq)
    feat = np.stack([np.asarray(jeng.encode(None)[0][0]) for _ in range(P)])
    return _arenas(np.stack(tseq.X_cam[:P]), _poses(tseq), feat)


def _assert_store_equal(jg, tg):
    assert tg.n_edges == jg.n_edges and tg.max_edges == jg.max_edges
    n = tg.n_edges
    np.testing.assert_array_equal(tg.ii[:n], jg.ii[:n])
    np.testing.assert_array_equal(tg.jj[:n], jg.jj[:n])
    for name in STORE:
        np.testing.assert_array_equal(
            getattr(tg, name)[:n].numpy(), np.asarray(getattr(jg, name))[:n],
            err_msg=name)


def _graphs(jeng, teng, cfg, K=None):
    return (jgo.FactorGraph(jeng, HW, cfg, K=K),
            go.FactorGraph(teng, HW, cfg, K=K, store_device="cpu"))


def _solve(jg, tg, ja, ta, rtype):
    jr, tr = jg.solve_poses(ja, rtype), tg.solve_poses(ta, rtype)
    np.testing.assert_array_equal(tr[0], np.asarray(jr[0]))
    assert tr[2][0] == jr[2][0] and tr[2][2] == jr[2][2]
    np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]),
                               atol=POSE_ATOL, rtol=0)
    return jr, tr


@pytest.mark.parametrize("rtype", ["ray", "calib"])
def test_symmetric_edges_and_solve_match_jax(seqs, rtype):
    """Symmetric ``add_factors`` through both oracles on a batch with a
    consecutive, a non-consecutive and a reversed pair (edge_query_subsample
    1 and 2 do not matter to the oracle, which matches at full size): the
    edge store equal bit for bit; then ``solve_poses`` with the cache."""
    jseq, tseq = seqs
    cfg = _cfg()
    K = np.asarray(jseq.K) if rtype == "calib" else None
    jg, tg = _graphs(jtesting.OracleEngine(jseq),
                     testing.OracleEngine(tseq, device="cpu"), cfg, K)
    ja, ta = _oracle_arenas(seqs)
    for ii, jj in (([0, 1], [1, 2]), ([2, 3, 0], [3, 1, 3])):
        assert jg.add_factors(ja, ii, jj, 0.1) == \
            tg.add_factors(ta, ii, jj, 0.1)
    _assert_store_equal(jg, tg)
    assert tg.n_edges >= 3
    jr, tr = _solve(jg, tg, ja, ta, rtype)
    # the write-back drops the pinned and padded rows
    jarena, _ = jg._solve(ja, rtype)
    tarena, _ = tg._solve(ta, rtype)
    np.testing.assert_allclose(tarena.T_WC.numpy(), np.asarray(jarena.T_WC),
                               atol=POSE_ATOL, rtol=0)


class IdentityEngine:
    """tests/test_global_opt.py:17: identity matches, confidence 4 (Q of
    ``q``), for either package."""

    def __init__(self, xp, q=4.0):
        self.xp, self.q = xp, q
        self.device = "cpu"

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j):
        B = feat_i.shape[0]
        if self.xp is torch:
            idx = torch.arange(HW)[None].expand(B, HW)
            valid = torch.ones((B, HW, 1), dtype=torch.bool)
            Q = torch.full((B, HW, 1), self.q)
        else:
            idx = jnp.broadcast_to(jnp.arange(HW, dtype=jnp.int32)[None],
                                   (B, HW))
            valid = jnp.ones((B, HW, 1), bool)
            Q = jnp.full((B, HW, 1), self.q)
        return idx, idx, valid, valid, Q, Q, Q, Q


def _identity_arenas():
    """tests/test_global_opt.py:34: every camera sees the same world
    points."""
    rng = np.random.default_rng(0)
    Wp = rng.standard_normal((HW, 3)).astype(np.float32)
    Wp[:, 2] += 4.0
    xi = rng.standard_normal((P, 7)).astype(np.float32) * 0.08
    xi[0] = 0
    T_true = sim3.exp(torch.from_numpy(xi))
    X = sim3.act(sim3.inv(T_true)[:, None], torch.from_numpy(Wp)).numpy()
    T0 = sim3.mul(sim3.exp(torch.from_numpy(
        np.random.default_rng(9).standard_normal((P, 7)).astype(np.float32)
        * 0.05 * (np.arange(P) > 0)[:, None])), T_true).numpy()
    return _arenas(X, T0, np.zeros((P, 16, 32), np.float32)), T_true.numpy()


def test_gating_rejects_weak_nonconsecutive_and_reloc_edges():
    """tests/test_global_opt.py:109: with confidences under Q_conf a
    non-consecutive edge is rejected, a consecutive one kept, and under
    ``is_reloc`` one weak edge rejects the whole batch; the same store on
    both sides."""
    cfg = _cfg()
    jg, tg = _graphs(IdentityEngine(jnp, 0.1), IdentityEngine(torch, 0.1),
                     cfg)
    (ja, ta), _ = _identity_arenas()
    for ii, jj, reloc, expect in (([0], [2], False, False),
                                  ([0], [1], False, True),
                                  ([3, 0], [1, 1], False, True),
                                  ([0], [3], True, False)):
        assert jg.add_factors(ja, ii, jj, 0.1, is_reloc=reloc) == expect
        assert tg.add_factors(ta, ii, jj, 0.1, is_reloc=reloc) == expect
    assert tg.n_edges == 2
    _assert_store_equal(jg, tg)


def test_edge_store_grows_past_max_edges():
    """tests/test_global_opt.py:140: a batch that passes the store's end
    grows it by powers of two, rows and endpoints intact, and the solve
    still recovers the truth."""
    cfg = _cfg(max_edges=2, max_iters=10)
    jg, tg = _graphs(IdentityEngine(jnp), IdentityEngine(torch), cfg)
    (ja, ta), T_true = _identity_arenas()
    for ii, jj, max_e in (([0, 1], [1, 2], 2), ([2], [3], 4),
                          ([0, 0, 1], [2, 3, 3], 8)):
        jg.add_factors(ja, ii, jj, 0.1)
        tg.add_factors(ta, ii, jj, 0.1)
        assert tg.max_edges == max_e and tg.ii.shape == (max_e,)
        assert tg.idx_ii2jj.shape == (max_e, HW)
        assert tg.pre_Xi_f.shape[0] == max_e == tg._pre_fresh.shape[0]
    assert tg.n_edges == 6
    _assert_store_equal(jg, tg)
    _solve(jg, tg, ja, ta, "ray")
    tarena, stats = tg.solve_GN_rays(ta)
    assert stats[2]
    assert np.abs(tarena.T_WC[:P].numpy() - T_true).max() < 1e-3
    np.testing.assert_array_equal(tarena.T_WC[P:].numpy(),
                                  sim3.identity((8 - P,)).numpy())


def test_no_solve_without_edges():
    cfg = _cfg()
    (ja, ta), _ = _identity_arenas()
    tg = go.FactorGraph(IdentityEngine(torch), HW, cfg, store_device="cpu")
    assert tg.solve_poses(ta, "ray") is None
    before = ta.T_WC.clone()
    assert tg.solve_GN_rays(ta)[1] is None
    assert torch.equal(ta.T_WC, before)
    # one pinned keyframe alone: nothing to solve either
    tg.add_factors(ta, [0], [0], 0.0)
    assert tg.n_edges == 1 and tg.solve_poses(ta, "ray") is None


def test_pregather_cache_matches_uncached(seqs):
    """tests/test_global_opt.py:198 in the port: cached and uncached solves
    agree bit for bit (the cache holds the rows the uncached solve
    gathers), after a keyframe's pointmap changes (N_updates) and
    after a new edge; ``test_symmetric_edges_and_solve_match_jax`` holds
    the cached solve against JAX's."""
    _, tseq = seqs
    graphs = {cache: go.FactorGraph(testing.OracleEngine(tseq, device="cpu"),
                                    HW, _cfg(cache_pregather=cache),
                                    store_device="cpu")
              for cache in (True, False)}
    assert graphs[True].cache_pre and not graphs[False].cache_pre
    _, ta = _oracle_arenas(seqs)
    for g in graphs.values():
        g.add_factors(ta, [0, 1], [1, 2], 0.0)
    solved = []
    for step in range(2):
        res = {c: g.solve_poses(ta, "ray") for c, g in graphs.items()}
        np.testing.assert_array_equal(res[True][0], res[False][0])
        assert res[True][2][0] == res[False][2][0]
        np.testing.assert_array_equal(res[True][1].numpy(),
                                      res[False][1].numpy())
        solved.append(res[True][1])
        if step == 0:
            # keyframe 2's pointmap changes and edge (2, 3) arrives
            ta.X[2] += 0.01
            ta.N_updates[2] += 1
            for g in graphs.values():
                g.add_factors(ta, [2], [3], 0.0)
    g = graphs[True]
    assert g._pre_fresh[:g.n_edges].all() and g.n_edges == 3
    assert solved[1].shape[0] == 4 and \
        not torch.allclose(solved[0][:3], solved[1][:3])


def test_refresh_is_selective(seqs):
    """Only the edges of a keyframe whose N_updates moved are gathered
    again."""
    jseq, tseq = seqs
    tg = go.FactorGraph(testing.OracleEngine(tseq, device="cpu"), HW, _cfg(),
                        store_device="cpu")
    _, ta = _oracle_arenas(seqs)
    tg.add_factors(ta, [0, 1, 2], [1, 2, 3], 0.0)
    tg.solve_poses(ta, "ray")
    refreshed = []
    orig = tg._refresh_pre
    tg._refresh_pre = lambda a, slots, calib: (refreshed.append(slots),
                                               orig(a, slots, calib))
    ta.N_updates[3] += 1
    tg.solve_poses(ta, "ray")
    assert refreshed == [[2]]
    tg.solve_poses(ta, "calib")        # residual mode change: all rows
    assert refreshed[-1] == [0, 1, 2]


class ReuseEngine:
    """The oracle plus a ``match_arrays_warp`` that returns the oracle's
    i -> j match on the edge subgrid (what the network engine returns at
    edge_query_subsample 2), for either package."""

    def __init__(self, oracle, xp):
        self.oracle, self.xp = oracle, xp
        self.device = "cpu"
        self.warps = 0

    def match_asymmetric(self, *args, **kw):
        return self.oracle.match_asymmetric(*args, **kw)

    def match_symmetric(self, *args, **kw):
        return self.oracle.match_symmetric(*args, **kw)

    def match_arrays_warp(self, X_arena, T_arena, i, j, D11, D21, img_hw):
        self.warps += 1
        idx, valid = self.oracle._match(int(i), int(j))
        h, w = img_hw
        idx = idx.reshape(h, w)[::2, ::2].reshape(1, -1)
        valid = valid.reshape(h, w)[::2, ::2].reshape(1, -1, 1)
        if self.xp is torch:
            return torch.from_numpy(idx.astype(np.int64)), \
                torch.from_numpy(valid)
        return jnp.asarray(idx, jnp.int32), jnp.asarray(valid)


@pytest.mark.parametrize("warp", [False, True], ids=["full-grid", "subgrid"])
def test_reused_consecutive_edge_matches_jax(seqs, warp):
    """The consecutive edge (1, 2) from the tracker's reused direction: the
    full-grid completion by ``match_asymmetric`` (oracle, no warp) and the
    pose-warped subgrid completion (desc8 tables present).  The bundle's
    Qjj / Qij and the two q8 tables are distinct, so a swapped pairing
    would show in the stored weights."""
    jseq, tseq = seqs
    jeng, teng = jtesting.OracleEngine(jseq), \
        testing.OracleEngine(tseq, device="cpu")
    if warp:
        jeng, teng = ReuseEngine(jeng, jnp), ReuseEngine(teng, torch)
    jg, tg = _graphs(jeng, teng, _cfg())
    ja, ta = _oracle_arenas(seqs)
    rng = np.random.default_rng(4)
    idx_j2i, vm_i = testing.OracleEngine(tseq, device="cpu")._match(2, 1)
    Qjj = rng.uniform(1.0, 5.0, (1, HW, 1)).astype(np.float32)
    Qij = rng.uniform(1.0, 5.0, (1, HW, 1)).astype(np.float32)
    d8 = [rng.integers(-127, 128, (1, HW, 8)).astype(np.int8)
          for _ in range(2)]
    bundle = dict(pair=(1, 2), idx_j2i=idx_j2i[None],
                  valid_i=vm_i[None, :, None], Qjj=Qjj, Qij=Qij, desc8_frame=d8[0] if warp else None,
                  desc8_kf=d8[1] if warp else None)

    def conv(xp):
        return {k: (v if k == "pair" or v is None else
                    (torch.from_numpy(v) if xp is torch else jnp.asarray(v)))
                for k, v in bundle.items()}

    assert jg.add_factors(ja, [1, 0], [2, 2], 0.0, reuse=conv(jnp))
    assert tg.add_factors(ta, [1, 0], [2, 2], 0.0, reuse=conv(torch))
    if warp:
        assert teng.warps == jeng.warps == 1
    _assert_store_equal(jg, tg)
    # the reused direction is stored as given, the warped one at the even
    # pixels only
    np.testing.assert_array_equal(tg.idx_jj2ii[0].numpy(), idx_j2i)
    if warp:
        odd = np.ones((H, W), bool)
        odd[::2, ::2] = False
        assert not tg.valid_match_j[0].numpy()[odd.ravel()].any()
    _solve(jg, tg, ja, ta, "ray")


def test_gate_and_direction_weights_bitwise():
    """``_gate_edges``, ``_gate_edges_sub``, ``_dir_weight`` and
    ``_dir_weight_sub`` on random inputs: equal bit for bit."""
    rng = np.random.default_rng(5)
    B, h, w = 2, 8, 12
    n, nq = h * w, (h // 2) * (w // 2)
    Q = [rng.uniform(0.5, 4.0, (B, n, 1)).astype(np.float32)
         for _ in range(4)]
    idx_full = rng.integers(0, n, (B, n))
    for m in (n, nq):
        idx = [rng.integers(0, n, (B, m)) for _ in range(2)]
        vm = [rng.uniform(size=(B, m, 1)) > 0.3 for _ in range(2)]
        args = idx + vm + Q + [1.5]
        j = (jgo._gate_edges(*[jnp.asarray(a) for a in args]) if m == n else
             jgo._gate_edges_sub(*[jnp.asarray(a) for a in args], h=h, w=w))
        t = (go._gate_edges(*[torch.as_tensor(a) for a in args]) if m == n
             else go._gate_edges_sub(*[torch.as_tensor(a) for a in args],
                                     h, w))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        go._dir_weight(*[torch.as_tensor(a) for a in (idx_full, Q[0], Q[1])])
        .numpy(), np.asarray(jgo._dir_weight(
            *[jnp.asarray(a) for a in (idx_full, Q[0], Q[1])])))
    tw = go._dir_weight_sub(*[torch.as_tensor(a) for a in
                              (idx[1], vm[1], Q[2], Q[3])], h, w)
    jw = jgo._dir_weight_sub(*[jnp.asarray(a) for a in
                               (idx[1], vm[1], Q[2], Q[3])], h=h, w=w)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_query_subsample_ba_bitwise():
    """tests/test_adversarial.py:457 in the port: edges matched on the
    (::2, ::2) query grid and scattered into the store give the same BA
    solve, bit for bit, as full-grid matches at points_subsample 4 (BA
    reads exactly the even pixels)."""
    h, w = H, W
    K = testing.make_K(h, w)
    T0 = sim3.identity()
    T1 = sim3.exp(torch.tensor([0.05, -0.03, 0.02, 0.02, -0.02, 0.03, 0.0]))
    _, Xc0, Xw0 = testing.render_view(T0, h, w, K, "smooth")
    _, Xc1, Xw1 = testing.render_view(T1, h, w, K, "smooth")
    D0 = torch.from_numpy(testing.world_descriptors(Xw0).reshape(1, h, w, -1))
    D1 = torch.from_numpy(testing.world_descriptors(Xw1).reshape(1, h, w, -1))
    rng = np.random.default_rng(3)
    Qs = [torch.from_numpy((3.0 + rng.standard_normal(h * w) * 0.2)
                           .astype(np.float32)).reshape(1, -1, 1)
          for _ in range(4)]
    X0 = torch.as_tensor(np.asarray(Xc0)).reshape(1, h, w, 3)
    X1 = torch.as_tensor(np.asarray(Xc1)).reshape(1, h, w, 3)

    class Eng:
        device = "cpu"

        def __init__(self, qsub):
            self.qsub = qsub
            self.match_cfg = matching.MatchingConfig(
                coarse_subsample=2, final_radius=1, coarse_radius=2,
                dilation_schedule=(4, 2), lm_subsample=4)

        def match_symmetric(self, fi, pi, fj, pj):
            X21 = torch.cat([sim3.act(sim3.rel(T0, T1), X1),
                             sim3.act(sim3.rel(T1, T0), X0)])
            idx, valid = matching.match(
                torch.cat([X0, X1]), X21, torch.cat([D0, D1]),
                torch.cat([D1, D0]), cfg=self.match_cfg,
                query_subsample=2 if self.qsub else 1)
            return (idx[:1], idx[1:], valid[:1], valid[1:], *Qs)

    def run(qsub):
        cfg = load_config("config/eval_no_calib.yaml")
        assert int(cfg["local_opt"]["points_subsample"]) == 4
        arena = tfr.make_arena(4, h, w, 16, 32, "cpu")
        arena.X[0], arena.X[1] = X0.reshape(-1, 3), X1.reshape(-1, 3)
        arena.C[:2], arena.N[:2] = 10.0, 1
        arena.T_WC[1] = sim3.mul(sim3.exp(torch.tensor(
            [0.03, -0.02, 0.02, 0.01, -0.01, 0.02, 0.0])), T1)
        arena.n_size = 2
        g = go.FactorGraph(Eng(qsub), h * w, cfg)
        assert g.add_factors(arena, [0], [1], 0.0)
        upd, Twc_new, stats = g.solve_poses(arena, "ray")
        assert stats[2]
        return Twc_new.numpy(), g.Q_ii2jj[0].numpy()

    T_full, Q_full = run(False)
    T_sub, Q_sub = run(True)
    np.testing.assert_array_equal(Q_sub.reshape(h, w)[::2, ::2],
                                  Q_full.reshape(h, w)[::2, ::2])
    np.testing.assert_array_equal(T_sub, T_full)


def test_slices_of_other_prs_raise():
    """A mesh with a backend device raises ``ValueError``, as in JAX
    (global_opt.py:328-332); ``device`` and ``mesh`` (the multi-GPU slice,
    ported) build a graph whose store is on that device, the mesh's without
    the pregather cache.  The desc_global edge matcher (reached when every
    endpoint has a stored table) is ported: all-zero tables fail its gates
    and the pair is retried through the symmetric path, which counts one
    desc_global batch and one fallback."""
    from mast3r_slam_torch.parallel.mesh import make_mesh

    cfg = load_config("config/base.yaml")
    eng = IdentityEngine(torch)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        go.FactorGraph(eng, HW, cfg, device="cpu", mesh=mesh)
    gd = go.FactorGraph(eng, HW, cfg, device="cpu", params=eng)
    assert gd.dev == gd.idx_ii2jj.device == torch.device("cpu")
    assert gd._eng is eng and gd.cache_pre
    gm = go.FactorGraph(eng, HW, cfg, mesh=mesh, shard_mode="map")
    assert gm.idx_ii2jj.device == mesh.devices[0, 0]
    assert gm._mesh_D == 2 and not gm.cache_pre
    g = go.FactorGraph(eng, HW, cfg, store_device="cpu")
    assert g.retrieval_edge_mode == "desc_global"
    (_, ta), _ = _identity_arenas()
    for r in (0, 2):
        g.store_desc(r, torch.zeros((1, HW, 8), dtype=torch.int8),
                     torch.ones((1, HW, 1)), H, W)
    assert g.add_factors(ta, [0], [2], 0.1) and g.n_edges == 1
    assert g.n_desc_batches == 1 and g.n_desc_fallbacks == 1
    # a pair without stored tables takes the symmetric path, as in JAX
    assert g.add_factors(ta, [0], [1], 0.1) and g.n_edges == 2
    assert g.n_desc_batches == 1
    # reference-exact (edge_query_subsample 1) always matches symmetrically
    cfg["matching"]["edge_query_subsample"] = 1
    assert go.FactorGraph(eng, HW, cfg, store_device="cpu") \
        .retrieval_edge_mode == "sym"


def test_store_device_is_the_engines_or_given():
    """The edge store lives on ``store_device``, by default on the
    engine's device; with neither the graph refuses to guess one."""
    cfg = load_config("config/base.yaml")
    eng = IdentityEngine(torch)
    assert go.FactorGraph(eng, HW, cfg).idx_ii2jj.device.type == "cpu"
    assert go.FactorGraph(None, HW, cfg, store_device="cpu").dev.type == "cpu"
    with pytest.raises(ValueError, match="store_device"):
        go.FactorGraph(None, HW, cfg)


def test_arena_grow_pop_and_pose_writes_match_jax():
    """``arena_grow`` (new slots zero with identity poses), ``arena_pop_last``
    and ``arena_update_poses`` (a slot outside the arena dropped, as JAX's
    scatter drops it) against the JAX package's, bit for bit."""
    (ja, ta), _ = _identity_arenas()
    jg, tg = jfr.arena_grow(ja, 16), tfr.arena_grow(ta, 16)
    assert tg.buffer == jg.buffer == 16 and tg.n_size == P
    for name in ("frame_id", "uimg", "T_WC", "X", "C", "N", "N_updates",
                 "feat", "pos"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    T_new = sim3.exp(torch.full((3, 7), 0.1)).numpy()
    upd = np.array([2, 1 << 30, 15], np.int64)
    jg = jfr.arena_update_poses(jg, jnp.asarray(T_new), jnp.asarray(upd))
    tg = tfr.arena_update_poses(tg, torch.from_numpy(T_new), upd)
    np.testing.assert_array_equal(tg.T_WC.numpy(), np.asarray(jg.T_WC))
    jg, tg = jfr.arena_pop_last(jg), tfr.arena_pop_last(tg)
    assert tg.n_size == int(jg.n_size) == P - 1
    with pytest.raises(ValueError):
        tfr.arena_grow(tg, 8)
