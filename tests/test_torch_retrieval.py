"""The port's retrieval modules and its pose-free descriptor matcher against
the JAX package, on the same seeded numpy inputs.

* ASMK host code (``retrieval/asmk.py``, copied): binarization, Hamming
  distances, aggregation, the inverted file's internal arrays after adds
  and merges, ``search`` and ``search_packed`` scores, bitwise; the
  codebook pickles of both published layouts load the same centroids;
  k-means training gives the same centroids.
* ``Codebook.quantize`` (the matmul on the device): the same word ids,
  also where centroids tie (the lower word first, as ``jax.lax.top_k``).
* ``retrieval/model.py``: ``RetrievalParams.random`` equal bit for bit;
  ``from_torch_checkpoint`` on a forged state dict (LayerNorm + GELU
  layers, whitening, the residual projector) gives the same weights bit for
  bit, and ``prep_features`` the same features within ``FEAT_RTOL`` 2e-6 of
  their largest magnitude (measured 4.6e-7; f32 products summed in another
  order), with tied tokens taken in token order.
* ``RetrievalDatabase`` on the 12-frame loop clip of
  ``tests/test_retrieval.py:89``: the same proposals, frame by frame.
* ``ops/matching.py::match_desc_global`` and ``_coarse_global_argmax`` at
  48x64 and 96x128 on a table and its shifted, noised copy (most gates
  pass), on two unrelated tables (most reject) and on tables with tied key
  rows: all eight outputs and (pos, score, second) bitwise.
"""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import testing as jtesting
from mast3r_slam_tpu.ops import matching as jmatching
from mast3r_slam_tpu.retrieval import asmk as jasmk
from mast3r_slam_tpu.retrieval import model as jmodel
from mast3r_slam_torch import testing
from mast3r_slam_torch.ops import matching
from mast3r_slam_torch.retrieval import asmk
from mast3r_slam_torch.retrieval import model
from mast3r_slam_torch.retrieval.database import RetrievalDatabase

FEAT_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codebooks(seed, K, D):
    C = np.random.default_rng(seed).standard_normal((K, D)).astype(np.float32)
    return jasmk.Codebook(C), asmk.Codebook(C, device="cpu")


# ---------------------------------------------------------------------------
# ASMK host code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(5, 130), (7, 64), (3, 1024), (4, 320),
                                 (1, 700), (2, 832)])
def test_binarize_and_hamming_match_jax(n, d):
    rng = np.random.default_rng(d)
    A = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.standard_normal((n + 2, d)).astype(np.float32)
    pa = asmk.binarize_and_pack_2d(A)
    np.testing.assert_array_equal(pa, jasmk.binarize_and_pack_2d(A))
    assert pa.dtype == np.uint64 and pa.shape == (n, -(-d // 64))
    pb = asmk.binarize_and_pack_2d(B)
    got = asmk.hamming_cdist_packed(pa, pb, dim=d)
    np.testing.assert_array_equal(got, jasmk.hamming_cdist_packed(pa, pb,
                                                                  dim=d))
    naive = ((A[:, None] > 0) != (B[None] > 0)).sum(-1) / np.float32(d)
    np.testing.assert_array_equal(got, naive.astype(np.float32))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "real"])
def test_aggregate_image_matches_jax(binary):
    """Including a descriptor given one word in every assignment slot and
    one in two of them (each counts once)."""
    rng = np.random.default_rng(0)
    jcb, tcb = _codebooks(0, 64, 32)
    des = rng.standard_normal((50, 32)).astype(np.float32)
    words = rng.integers(0, 64, (50, 5)).astype(np.int32)
    words[0, :] = 7
    words[1, :2] = 9
    got = asmk.ASMKKernel(tcb, binary).aggregate_image(des, words)
    ref = jasmk.ASMKKernel(jcb, binary).aggregate_image(des, words)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def _fill_ivfs(rng, kern_j, kern_t, K, D, n_images, rows):
    ivf_j, ivf_t = jasmk.IVF(K), asmk.IVF(K)
    for im in range(n_images):
        des = rng.standard_normal((rows, D)).astype(np.float32)
        words = rng.integers(0, K, (rows, 1)).astype(np.int32)
        a_j, w_j = kern_j.aggregate_image(des, words)
        a_t, w_t = kern_t.aggregate_image(des, words)
        ivf_j.add(a_j, w_j, np.full(len(w_j), im, np.int64))
        ivf_t.add(a_t, w_t, np.full(len(w_t), im, np.int64))
    return ivf_j, ivf_t


IVF_ARRAYS = ("counts", "_starts", "_csr_vecs", "_csr_imids", "_pend_vecs",
              "_pend_words", "_pend_imids", "norm_factor")


@pytest.mark.parametrize("rows", [20, 90], ids=["pending", "merged"])
def test_ivf_add_and_search_match_jax(rows):
    """Adds with and without a merge of the pending tail (more than 256
    pending rows): every internal array equal; ``search`` and
    ``search_packed`` scores equal to JAX's, bitwise, and to each other
    (bitwise once everything is merged, where both sum in one order;
    within 1e-12 with a tail, which search_packed adds after the arena)."""
    rng = np.random.default_rng(1)
    K, D = 32, 64
    jcb, tcb = _codebooks(1, K, D)
    kj, kt = jasmk.ASMKKernel(jcb), asmk.ASMKKernel(tcb)
    ivf_j, ivf_t = _fill_ivfs(rng, kj, kt, K, D, 12, rows)
    assert (ivf_t._csr_vecs is None) == (rows == 20)
    for name in IVF_ARRAYS:
        a, b = getattr(ivf_t, name), getattr(ivf_j, name)
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ivf_t._pend_n == ivf_j._pend_n and ivf_t.n_images == 12

    qdes = rng.standard_normal((25, D)).astype(np.float32)
    qwords = rng.integers(0, K, (25, 3)).astype(np.int32)
    ades, wids = kt.aggregate_image(qdes, qwords)

    def sim(kern):
        return lambda q, v, i: kern.similarity(q, v, i, alpha=3.0,
                                               similarity_threshold=0.0)

    full = {}
    for name, ivf, kern in (("port", ivf_t, kt), ("jax", ivf_j, kj)):
        r1, s1 = ivf.search(ades, wids, sim(kern))
        r2, s2 = ivf.search_packed(ades, wids, D, alpha=3.0,
                                   similarity_threshold=0.0)
        full[name] = (r1, s1, r2, s2)
    for a, b in zip(full["port"], full["jax"]):
        np.testing.assert_array_equal(a, b)
    r1, s1, r2, s2 = full["port"]
    f1, f2 = np.zeros(12), np.zeros(12)
    f1[r1], f2[r2] = s1, s2
    if ivf_t._pend_n == 0:
        np.testing.assert_array_equal(f2, f1)
    else:
        np.testing.assert_allclose(f2, f1, rtol=0, atol=1e-12)
    assert r1[0] == r2[0]


def _forge_asmk_instance_pickle(path, cent):
    """An asmk ``Codebook`` instance pickled under a forged ``asmk``
    package (tests/test_retrieval.py:171)."""
    pkg, mod = types.ModuleType("asmk"), types.ModuleType("asmk.codebook")

    class FakeRefCodebook:
        pass

    FakeRefCodebook.__module__ = "asmk.codebook"
    FakeRefCodebook.__qualname__ = FakeRefCodebook.__name__ = "Codebook"
    mod.Codebook, pkg.codebook = FakeRefCodebook, mod
    sys.modules["asmk"], sys.modules["asmk.codebook"] = pkg, mod
    try:
        inst = FakeRefCodebook()
        inst.params, inst.size, inst.centroids = {"size": len(cent)}, \
            len(cent), cent
        inst.search_index = inst.index_factory = None
        with open(path, "wb") as f:
            pickle.dump(inst, f)
    finally:
        del sys.modules["asmk"], sys.modules["asmk.codebook"]


@pytest.mark.parametrize("layout", ["state_dict", "asmk_instance"])
def test_codebook_load_matches_jax(tmp_path, layout):
    cent = np.random.default_rng(2).standard_normal((32, 8)).astype(
        np.float32)
    p = tmp_path / "codebook.pkl"
    if layout == "state_dict":
        with open(p, "wb") as f:
            pickle.dump({"type": "Codebook", "params": {"size": "64k"},
                         "state": {"centroids": cent}}, f)
    else:
        _forge_asmk_instance_pickle(p, cent)
        with pytest.raises(ModuleNotFoundError):
            with open(p, "rb") as f:
                pickle.load(f)
    cb = asmk.Codebook.load(p, device="cpu")
    np.testing.assert_array_equal(cb.centroids, jasmk.Codebook.load(
        str(p)).centroids)
    np.testing.assert_array_equal(cb.centroids, cent)
    np.testing.assert_array_equal(cb.quantize(cent[:5])[:, 0], np.arange(5))


@pytest.mark.parametrize("ma", [1, 3, 5])
def test_quantize_matches_jax(ma):
    """Seeded queries against a seeded codebook, then a codebook whose
    words come in identical pairs: each query's distances tie pairwise and
    both packages list the lower word first."""
    rng = np.random.default_rng(3)
    jcb, tcb = _codebooks(3, 256, 32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    ids = tcb.quantize(q, ma)
    assert ids.dtype == np.int32 and ids.shape == (300, ma)
    np.testing.assert_array_equal(ids, jcb.quantize(q, ma))
    np.testing.assert_array_equal(ids, tcb.quantize(torch.from_numpy(q), ma))
    C = np.repeat(jcb.centroids[:16], 2, axis=0)
    tie_j, tie_t = jasmk.Codebook(C), asmk.Codebook(C, device="cpu")
    ids = tie_t.quantize(q, ma)
    np.testing.assert_array_equal(ids, tie_j.quantize(q, ma))
    if ma > 1:
        assert (ids[:, 1] == ids[:, 0] + 1).all() and \
            (ids[:, 0] % 2 == 0).all()


def test_codebook_train_matches_jax():
    X = np.random.default_rng(4).standard_normal((200, 16)).astype(np.float32)
    got = asmk.Codebook.train(X, 24, n_iter=4, seed=1, device="cpu")
    np.testing.assert_array_equal(
        got.centroids, jasmk.Codebook.train(X, 24, n_iter=4,
                                            seed=1).centroids)
    np.testing.assert_array_equal(got._centroids_dev.numpy(), got.centroids)


# ---------------------------------------------------------------------------
# Retrieval head
# ---------------------------------------------------------------------------

def test_random_params_match_jax():
    for d_in, hdims in ((32, (32,)), (48, (64, 40, 24))):
        tp = model.RetrievalParams.random(d_in, hdims, seed=5)
        jp = jmodel.RetrievalParams.random(jax.random.PRNGKey(0), d_in,
                                           hdims, seed=5)
        for (tW, tb), (jW, jb) in zip(tp.proj_weights, jp.proj_weights):
            np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert len(tp.proj_norms) == len(jp.proj_norms) == len(hdims) - 1
        np.testing.assert_array_equal(tp.postwhiten_p.numpy(),
                                      np.asarray(jp.postwhiten_p))


def _forged_checkpoint(path, d_in, hdims, residual, seed):
    """A retrieval checkpoint in the published key layout: Linear and
    LayerNorm weights under consecutive ``projector.{i}`` indices (both
    converters read them up to the first missing index), Linear weights
    stored (out, in), random whiteners, ``args.residual``."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    sd, d, i = {}, d_in, 0
    for k, h in enumerate(hdims):
        sd[f"projector.{i}.weight"] = t(h, d, scale=d ** -0.5)
        sd[f"projector.{i}.bias"] = t(h, scale=0.1)
        i += 1
        if k < len(hdims) - 1:
            sd[f"projector.{i}.weight"] = 1.0 + t(h, scale=0.1)
            sd[f"projector.{i}.bias"] = t(h, scale=0.1)
            i += 1
        d = h
    sd["prewhiten.m"] = t(1, d_in, scale=0.1)
    sd["prewhiten.p"] = torch.eye(d_in) + t(d_in, d_in, scale=0.05)
    sd["postwhiten.m"] = t(1, d, scale=0.1)
    sd["postwhiten.p"] = torch.eye(d) + t(d, d, scale=0.05)
    torch.save({"model": sd,
                "args": types.SimpleNamespace(residual=residual)}, path)


@pytest.mark.parametrize("hdims,residual", [((64, 48), False),
                                            ((64, 48, 48), True)],
                         ids=["plain", "residual"])
def test_checkpoint_and_prep_features_match_jax(tmp_path, hdims, residual):
    """The forged checkpoint through both converters (weights bitwise),
    then ``prep_features`` on seeded tokens: the same selected tokens in
    the same order, features within ``FEAT_RTOL`` of their largest
    magnitude."""
    d_in = hdims[-1] if residual else 40
    p = tmp_path / "retrieval.pth"
    _forged_checkpoint(p, d_in, hdims, residual, seed=6)
    tp = model.RetrievalParams.from_torch_checkpoint(p)
    jp = jmodel.RetrievalParams.from_torch_checkpoint(str(p))
    assert tp.residual == jp.residual == residual
    assert len(tp.proj_norms) == len(hdims) - 1
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tp[:-1])),
                    jax.tree_util.tree_leaves(tuple(jp[:-1]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    feat = np.random.default_rng(7).standard_normal((2, 96, d_in)) \
        .astype(np.float32)
    got = model.prep_features(tp, torch.from_numpy(feat), 30,
                              residual=residual).numpy()
    ref = np.asarray(jmodel.prep_features(jp, jnp.asarray(feat), 30,
                                          residual=residual))
    assert got.shape == ref.shape == (2, 30, hdims[-1])
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"prep_features {hdims} residual={residual}: max abs err "
          f"{err:.3g} of the largest feature")
    assert err <= FEAT_RTOL


def test_prep_features_ties_keep_token_order():
    """Tokens of equal attention are taken in token order, as
    ``jax.lax.top_k`` takes them."""
    params = model.RetrievalParams.random(16, (16,), seed=0)
    feat = np.random.default_rng(8).standard_normal((1, 6, 16)).astype(
        np.float32)
    feat = np.repeat(feat, 3, axis=1)          # every token three times
    got = model.prep_features(params, torch.from_numpy(feat), 9).numpy()
    jp = jmodel.RetrievalParams.random(jax.random.PRNGKey(0), 16, (16,))
    ref = np.asarray(jmodel.prep_features(jp, jnp.asarray(feat), 9))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FEAT_RTOL * np.abs(ref).max())
    # tied rows come in threes, taken in token order: rows 3k..3k+2 equal
    for k in range(3):
        assert (got[0, 3 * k:3 * k + 3] == got[0, 3 * k]).all()
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    assert model.top_k_indices(x, 4).tolist() == [[1, 2, 4, 3]]


# ---------------------------------------------------------------------------
# The database on the loop clip
# ---------------------------------------------------------------------------

class _Frame:
    def __init__(self, feat):
        self.feat = feat


def test_database_proposals_match_jax(tmp_path):
    """The 12-frame loop clip of ``tests/test_retrieval.py:89`` through
    ``make_oracle_retrieval`` on both sides: frames 0-9 queried and added,
    10 and 11 queried only; the same proposals frame by frame, the loop's
    last frame proposing an early keyframe."""
    jseq = jtesting.SyntheticSequence(n_frames=12, h=32, w=48, seed=1,
                                      traj_scale=0.35, loop=True)
    jseq.save(tmp_path / "o.npz")
    tseq = testing.SyntheticSequence.load(tmp_path / "o.npz")
    jeng, teng = jtesting.OracleEngine(jseq), testing.OracleEngine(
        tseq, device="cpu")
    jdb = jtesting.make_oracle_retrieval(jseq, jeng)
    tdb = testing.make_oracle_retrieval(tseq, teng)
    assert isinstance(tdb, RetrievalDatabase)
    np.testing.assert_array_equal(tdb.codebook.centroids,
                                  jdb.codebook.centroids)
    props = []
    for i in range(12):
        jf, tf = jeng.encode(None)[0][0], teng.encode(None)[0][0]
        add = i < 10
        a = jdb.update(_Frame(jf), add_after_query=add, k=3, min_thresh=0.0)
        b = tdb.update(_Frame(tf), add_after_query=add, k=3, min_thresh=0.0)
        assert b == a, (i, b, a)
        props.append(b)
    assert tdb.kf_counter == jdb.kf_counter == 10
    assert props[0] == [] and min(props[-1]) <= 2, props


# ---------------------------------------------------------------------------
# Pose-free descriptor matching
# ---------------------------------------------------------------------------

def _q8(X):
    X = X / np.linalg.norm(X, axis=-1, keepdims=True)
    return np.clip(np.round(X * 127.0), -127, 127).astype(np.int8)


def _desc_pair(kind, h, w, seed=0):
    """Two (1, h, w, 24) int8 tables: a smooth unit-descriptor field and
    its copy shifted by (5, 3) px with noise ("shift"), an unrelated field
    ("unrelated"), or the field with every 8x8 block repeated from its
    corner against its shifted copy ("ties": key rows of the stride-4 grid
    come in equal pairs, so coarse scores tie)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = gaussian_filter(
        rng.standard_normal((1, h + 8, w + 8, 24)).astype(np.float32),
        (0, 1.5, 1.5, 0))
    A = base[:, :h, :w]
    B = base[:, 3:3 + h, 5:5 + w] + 0.05 * rng.standard_normal(
        (1, h, w, 24)).astype(np.float32)
    if kind == "unrelated":
        B = rng.standard_normal((1, h, w, 24)).astype(np.float32)
    elif kind == "ties":
        A = np.repeat(np.repeat(A[:, ::8, ::8], 8, axis=1), 8, axis=2)
    return _q8(A), _q8(B)


_mdg_jax = jax.jit(jmatching.match_desc_global,
                   static_argnames=("h", "w", "cfg"))


@pytest.mark.parametrize("kind", ["shift", "unrelated", "ties"])
@pytest.mark.parametrize("h,w", [(48, 64), (96, 128)], ids=["48x64",
                                                            "96x128"])
def test_match_desc_global_bitwise(kind, h, w):
    D8_i, D8_j = _desc_pair(kind, h, w)
    rng = np.random.default_rng(9)
    ci, cj = (rng.uniform(1.0, 5.0, (1, h * w, 1)).astype(np.float32)
              for _ in range(2))
    ref = _mdg_jax(*(jnp.asarray(x) for x in (D8_i, D8_j, ci, cj)), h=h, w=w,
                   cfg=jmatching.MatchingConfig())
    got = matching.match_desc_global(
        *(torch.from_numpy(x) for x in (D8_i, D8_j, ci, cj)), h, w,
        matching.MatchingConfig())
    assert len(got) == len(ref) == 8
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == r.shape, k
        np.testing.assert_array_equal(g.numpy(), r, err_msg=f"output {k}")
    vm = float(np.concatenate([np.asarray(ref[2]), np.asarray(ref[3])]).mean())
    if kind == "shift":
        assert vm > 0.5, vm
    elif kind == "unrelated":
        assert vm < 0.05, vm

    # the coarse stage alone, in chunks smaller than the query count
    q4 = D8_j[:, ::4, ::4].reshape(1, -1, 24)
    cref = jmatching._coarse_global_argmax(jnp.asarray(D8_i), jnp.asarray(q4),
                                           h, w, s_key=4)
    cgot = matching._coarse_global_argmax(torch.from_numpy(D8_i),
                                          torch.from_numpy(q4), h, w,
                                          s_key=4, chunk=100)
    for g, r in zip(cgot, cref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if kind == "ties":
        keys = D8_i[:, ::4, ::4].reshape(-1, 24).astype(np.int64)
        s = q4[0].astype(np.int64) @ keys.T
        n_tied = int(((s == s.max(-1, keepdims=True)).sum(-1) > 1).sum())
        assert n_tied == q4.shape[1], n_tied    # every query's best ties
