"""ASMK (Aggregated Selective Match Kernel) retrieval core.

Mirrors ``mast3r_slam_tpu/retrieval/asmk.py``: codebook quantization,
per-visual-word residual aggregation with binarization, packed-Hamming
similarity with the monomial kernel, and a growable inverted file.

The codebook assignment (queries x codebook-size L2 top-k, the FLOP-heavy
part) runs on the codebook's device as one matmul with the JAX formula
|q|^2 + |c|^2 - 2 q c^T.  Everything else is host numpy, copied from the
JAX module: binarization and popcount (``np.bitwise_count``), the
aggregation and the inverted file.  The JAX module's optional compiled
Hamming extension (``retrieval/native``) is not loaded here; the database
path (``IVF.search_packed``) never calls it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .model import top_k_indices

# ---------------------------------------------------------------------------
# Binarization + Hamming (asmk.py:33-75)
# ---------------------------------------------------------------------------

if hasattr(np, "bitwise_count"):
    _popcount_u64 = np.bitwise_count
else:  # NumPy < 2.0: byte-LUT popcount
    _POPCNT_LUT = np.unpackbits(
        np.arange(256, dtype=np.uint8)[:, None], axis=1
    ).sum(axis=1).astype(np.uint8)

    def _popcount_u64(x: np.ndarray) -> np.ndarray:
        return _POPCNT_LUT[x.view(np.uint8)].reshape(
            x.shape + (x.dtype.itemsize,)).sum(axis=-1, dtype=np.int64)


def binarize_and_pack_2d(X: np.ndarray) -> np.ndarray:
    """Sign-binarize rows and pack the bits into uint64 words, little bit
    order (asmk.py:48)."""
    bits = (X > 0).astype(np.uint8)
    pad = (-bits.shape[1]) % 64
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((bits.shape[0], pad), np.uint8)], axis=1)
    packed = np.packbits(bits, axis=1, bitorder="little")
    return packed.view(np.uint64)


def hamming_cdist_packed(A: np.ndarray, B: np.ndarray,
                         dim: Optional[int] = None) -> np.ndarray:
    """Normalized pairwise Hamming distance between packed uint64 rows, in
    [0, 1] (asmk.py:62, its numpy route)."""
    x = np.bitwise_xor(A[:, None, :], B[None, :, :])
    counts = _popcount_u64(x).sum(axis=-1)
    d = dim or A.shape[1] * 64
    return counts.astype(np.float32) / d


# ---------------------------------------------------------------------------
# Codebook (asmk.py:78)
# ---------------------------------------------------------------------------

class Codebook:
    """Visual-word codebook with the top-k assignment on ``device``."""

    def __init__(self, centroids: np.ndarray, device="cuda"):
        self.centroids = np.asarray(centroids, np.float32)
        self.size, self.dim = self.centroids.shape
        self.device = resolve_device(device)
        self._centroids_dev = torch.from_numpy(self.centroids).to(self.device)
        self._c_sq = (self._centroids_dev ** 2).sum(dim=1)

    def quantize(self, qvecs, multiple_assignment: int = 1) -> np.ndarray:
        """(n, dim) host array or tensor -> (n, multiple_assignment) int32
        word ids, nearest first, ties in word order (asmk.py:88-106)."""
        q = torch.as_tensor(qvecs, dtype=torch.float32).to(self.device)
        d = (q ** 2).sum(dim=1)[:, None] + self._c_sq[None, :] \
            - 2.0 * q @ self._centroids_dev.T
        idx = top_k_indices(-d, multiple_assignment)
        return idx.to(torch.int32).cpu().numpy()

    @classmethod
    def train(cls, X: np.ndarray, size: int, n_iter: int = 10, seed: int = 0,
              device="cuda") -> "Codebook":
        """Plain k-means on the host (asmk.py:108)."""
        rng = np.random.default_rng(seed)
        X = np.asarray(X, np.float32)
        idx = rng.choice(len(X), size=min(size, len(X)), replace=False)
        C = X[idx].copy()
        if len(C) < size:
            C = np.concatenate(
                [C, rng.standard_normal((size - len(C), X.shape[1]))
                 .astype(np.float32)])
        for _ in range(n_iter):
            d = ((X ** 2).sum(1)[:, None] + (C ** 2).sum(1)[None, :]
                 - 2 * X @ C.T)
            a = d.argmin(1)
            for j in range(size):
                m = a == j
                if m.any():
                    C[j] = X[m].mean(0)
        return cls(C, device=device)

    @classmethod
    def load(cls, path, device="cuda") -> "Codebook":
        """Load a codebook pickle without the asmk package (asmk.py:129).

        The published ``*_codebook.pkl`` is ``Codebook.state_dict()``, a
        dict ``{"type": "Codebook", "params": {...}, "state":
        {"centroids": ndarray}}``.  Older caches pickled the asmk
        ``Codebook`` instance itself; an unpickler that stubs every
        ``asmk.*`` class rebuilds those without the package.  Plain arrays
        and dicts are accepted too."""
        import io
        import pickle

        class _Stub:
            """Stand-in for any asmk class: keeps the pickled attribute
            state without running the class's ``__init__``."""

            def __setstate__(self, state):
                if isinstance(state, dict):
                    self.__dict__.update(state)
                else:  # pragma: no cover - exotic __reduce__ protocols
                    self.__dict__["_state"] = state

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module == "asmk" or module.startswith("asmk."):
                    return type(name, (_Stub,), {"__module__": module})
                return super().find_class(module, name)

        with open(path, "rb") as f:
            obj = _Unpickler(io.BufferedReader(f)).load()

        def extract(o):
            if isinstance(o, np.ndarray):
                return o
            if isinstance(o, dict):
                if "state" in o and isinstance(o["state"], dict):
                    got = extract(o["state"])
                    if got is not None:
                        return got
                for key in ("centroids", "codebook", "C"):
                    if key in o:
                        got = extract(o[key])
                        if got is not None:
                            return got
                return None
            cent = getattr(o, "centroids", None)
            if cent is not None:
                return np.asarray(cent)
            return None

        cent = extract(obj)
        if cent is None:
            raise ValueError(f"unrecognized codebook format in {path}")
        return cls(np.asarray(cent, np.float32), device=device)


# ---------------------------------------------------------------------------
# Kernel: aggregation + similarity (asmk.py:195)
# ---------------------------------------------------------------------------

class ASMKKernel:
    def __init__(self, codebook: Codebook, binary: bool = True):
        self.codebook = codebook
        self.binary = binary

    def aggregate_image(self, des: np.ndarray, word_ids: np.ndarray):
        """Residuals summed per unique visual word, then binarized
        (asmk.py:200).  One sort of (word, descriptor) pairs and one
        ``np.add.reduceat`` in that order; a descriptor given the same word
        in several assignment slots counts once."""
        n, ma = word_ids.shape
        di = np.repeat(np.arange(n, dtype=np.int64), ma)
        wi = np.asarray(word_ids, np.int64).reshape(-1)
        key = np.unique(wi * np.int64(n) + di)
        w_sorted = key // n
        d_sorted = key % n
        unique_ids, starts, counts = np.unique(
            w_sorted, return_index=True, return_counts=True)
        unique_ids = unique_ids.astype(np.asarray(word_ids).dtype)
        sums = np.add.reduceat(
            des[d_sorted].astype(np.float32), starts, axis=0)
        ades = sums - counts[:, None].astype(np.float32) \
            * self.codebook.centroids[unique_ids]
        if self.binary:
            return binarize_and_pack_2d(ades), unique_ids
        nrm = np.linalg.norm(ades, axis=1, keepdims=True)
        return ades / np.maximum(nrm, 1e-12), unique_ids

    def similarity(self, qvec, vecs, image_ids, alpha: float = 3.0,
                   similarity_threshold: float = 0.0):
        """Monomial kernel over (binary) similarities (asmk.py:230)."""
        if self.binary:
            nd = hamming_cdist_packed(
                qvec.reshape(1, -1), vecs, dim=self.codebook.dim)
            sim = -2.0 * nd[0] + 1.0
        else:
            sim = vecs @ qvec
        mask = sim >= similarity_threshold
        sim = np.sign(sim[mask]) * np.abs(sim[mask]) ** alpha
        return image_ids[mask], sim


# ---------------------------------------------------------------------------
# Inverted file (asmk.py:250, use_idf=False)
# ---------------------------------------------------------------------------

class IVF:
    """Growable inverted file over packed binary residuals (asmk.py:250).

    All posting rows live in one flat arena sorted by visual word
    (``_csr_vecs`` / ``_csr_imids`` with ``_starts`` / ``counts``); adds
    append to a pending tail that is merged into the arena once it exceeds
    a quarter of it.  Queries score the arena and the tail in two additive
    passes."""

    def __init__(self, codebook_size: int):
        self.codebook_size = codebook_size
        self.counts = np.zeros(codebook_size, np.int64)  # arena only
        self._starts = np.zeros(codebook_size, np.int64)
        self._csr_vecs = None      # (N, W) uint64 arena, sorted by word
        self._csr_imids = np.zeros(0, np.int64)
        self._pend_vecs = None     # (cap, W) uint64 tail
        self._pend_words = np.zeros(0, np.int64)
        self._pend_imids = np.zeros(0, np.int64)
        self._pend_n = 0
        self.norm_factor = np.zeros(0)
        self.n_images = 0

    # -- storage -----------------------------------------------------------

    def _merge(self):
        """Fold the pending tail into the word-sorted arena (asmk.py:280)."""
        if self._pend_n == 0:
            return
        pw = self._pend_words[: self._pend_n]
        pv = self._pend_vecs[: self._pend_n]
        pi = self._pend_imids[: self._pend_n]
        if self._csr_vecs is None:
            words = pw
            vecs = pv.copy()
            imids = pi.copy()
        else:
            words = np.repeat(np.arange(self.codebook_size, dtype=np.int64),
                              self.counts)
            words = np.concatenate([words, pw])
            vecs = np.concatenate([self._csr_vecs, pv])
            imids = np.concatenate([self._csr_imids, pi])
        order = np.argsort(words, kind="stable")
        self._csr_vecs = vecs[order]
        self._csr_imids = imids[order]
        cnts = np.bincount(words, minlength=self.codebook_size)
        self.counts = cnts.astype(np.int64)
        self._starts = np.concatenate(
            [[0], np.cumsum(cnts)[:-1]]).astype(np.int64)
        self._pend_n = 0

    def add(self, des, word_ids, image_ids):
        """(asmk.py:307)"""
        des = np.asarray(des)
        word_ids = np.asarray(word_ids, np.int64).reshape(-1)
        image_ids = np.asarray(image_ids, np.int64).reshape(-1)
        max_imid = int(image_ids.max())
        if max_imid + 1 > len(self.norm_factor):
            self.norm_factor = np.concatenate(
                [self.norm_factor,
                 np.zeros(max_imid + 1 - len(self.norm_factor))])
        self.n_images = max(self.n_images, max_imid + 1)
        np.add.at(self.norm_factor, image_ids, 1.0)
        n = len(word_ids)
        need = self._pend_n + n
        if self._pend_vecs is None or need > self._pend_vecs.shape[0]:
            cap = max(64, int(need * 1.5))
            nv = np.zeros((cap,) + des.shape[1:], des.dtype)
            nw = np.zeros(cap, np.int64)
            ni = np.zeros(cap, np.int64)
            if self._pend_n:
                nv[: self._pend_n] = self._pend_vecs[: self._pend_n]
                nw[: self._pend_n] = self._pend_words[: self._pend_n]
                ni[: self._pend_n] = self._pend_imids[: self._pend_n]
            self._pend_vecs, self._pend_words, self._pend_imids = nv, nw, ni
        self._pend_vecs[self._pend_n: need] = des
        self._pend_words[self._pend_n: need] = word_ids
        self._pend_imids[self._pend_n: need] = image_ids
        self._pend_n = need
        n_csr = 0 if self._csr_vecs is None else len(self._csr_vecs)
        if self._pend_n > max(256, n_csr // 4):
            self._merge()

    def _postings(self, w: int):
        """(vecs, imids) of one word: its arena range and its pending rows
        (for the callback-form ``search``)."""
        s, c = int(self._starts[w]), int(self.counts[w])
        parts_v, parts_i = [], []
        if c and self._csr_vecs is not None:
            parts_v.append(self._csr_vecs[s: s + c])
            parts_i.append(self._csr_imids[s: s + c])
        if self._pend_n:
            hit = np.nonzero(self._pend_words[: self._pend_n] == w)[0]
            if len(hit):
                parts_v.append(self._pend_vecs[hit])
                parts_i.append(self._pend_imids[hit])
        if not parts_v:
            return None, None
        return np.concatenate(parts_v), np.concatenate(parts_i)

    # -- queries -----------------------------------------------------------

    def search(self, des, word_ids, similarity_func, topk=None):
        """The general callback form, one word at a time (asmk.py:358)."""
        scores = np.zeros(self.n_images)
        q_norm_factor = 0.0
        for qvec, word in zip(des, word_ids):
            w = int(word)
            q_norm_factor += 1.0
            vecs, image_ids = self._postings(w)
            if vecs is None:
                continue
            image_ids, sim = similarity_func(qvec, vecs, image_ids)
            sim = sim / np.sqrt(self.norm_factor[image_ids])
            np.add.at(scores, image_ids, sim)
        scores = scores / np.sqrt(max(q_norm_factor, 1.0))
        ranks = np.argsort(-scores)[:topk]
        return ranks, scores[ranks]

    def _score_pairs(self, Q, V, imids, dim, alpha, similarity_threshold,
                     scores):
        nd = _popcount_u64(
            np.bitwise_xor(Q, V)).sum(axis=-1).astype(np.float32) / dim
        sim = -2.0 * nd + 1.0
        mask = sim >= similarity_threshold
        sim = np.sign(sim[mask]) * np.abs(sim[mask]) ** alpha
        imids = imids[mask]
        sim = sim / np.sqrt(self.norm_factor[imids])
        np.add.at(scores, imids, sim)

    def search_packed(self, des, word_ids, dim, alpha=3.0,
                      similarity_threshold=0.0, topk=None):
        """``search`` for the binary kernel in two vectorized passes, one
        XOR + popcount over the arena's posting rows of the query words and
        one over the pending tail (asmk.py:389); the same scores, since
        they are sums."""
        des = np.asarray(des)
        word_ids = np.asarray(word_ids, np.int64).reshape(-1)
        nq = len(des)
        scores = np.zeros(self.n_images)
        if self._csr_vecs is not None:
            cnts = self.counts[word_ids]
            total = int(cnts.sum())
            if total:
                row0 = np.repeat(self._starts[word_ids], cnts)
                cum = np.cumsum(cnts) - cnts
                offs = np.arange(total, dtype=np.int64) - np.repeat(cum,
                                                                    cnts)
                rows = row0 + offs
                self._score_pairs(
                    np.repeat(des, cnts, axis=0), self._csr_vecs[rows],
                    self._csr_imids[rows], dim, alpha,
                    similarity_threshold, scores)
        # pending rows against the sorted query words; duplicate query
        # words (callers other than aggregate_image) pair with every copy
        if self._pend_n:
            qsort = np.argsort(word_ids, kind="stable")
            qws = word_ids[qsort]
            pw = self._pend_words[: self._pend_n]
            lo = np.searchsorted(qws, pw, side="left")
            hi = np.searchsorted(qws, pw, side="right")
            reps = hi - lo
            sel = np.nonzero(reps > 0)[0]
            if len(sel):
                reps_s = reps[sel]
                total = int(reps_s.sum())
                cum = np.cumsum(reps_s) - reps_s
                offs = np.arange(total, dtype=np.int64) - np.repeat(cum,
                                                                    reps_s)
                q_rows = qsort[np.repeat(lo[sel], reps_s) + offs]
                p_rows = np.repeat(sel, reps_s)
                self._score_pairs(
                    des[q_rows], self._pend_vecs[p_rows],
                    self._pend_imids[p_rows], dim, alpha,
                    similarity_threshold, scores)
        scores = scores / np.sqrt(max(float(nq), 1.0))
        ranks = np.argsort(-scores)[:topk]
        return ranks, scores[ranks]
