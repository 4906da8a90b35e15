"""The tracked-FPS benchmark of the port, the counterpart of ``bench.py``.

Measures the frontend frame step at production resolution (384x512, the
ViT-L two-view network with bf16 heads, seeded random weights conditioned
so that the matcher and the solve do real work; random weights cost the
same operations as trained ones): the encoder, then the two-view decode +
heads, the dense match and the Sim(3) Gauss-Newton solve at the
pipeline-measured iteration cadence, and beside them the stages a keyframe
adds (the pose-warped edge, the BA round, the retrieval update and the
loop-closure edges), composed into the protocol rate with the measured
rates of ``bench_rates.json``, as ``bench.py`` composes them.

Timing: each stage is called twice to warm up, then ``BENCH_CHAIN`` times,
each call between two ``torch.cuda.synchronize()`` on the host clock; the
median is the stage's time.  That is the time the frame loop sees, since a
frame ends with host reads.  The same calls' CUDA-event time and the device
busy time of one traced call go to stderr beside it.  Eager PyTorch caches
no result between calls and drops no unused output, so each call is made
again on the same inputs: the chained ``fori_loop`` with data dependencies
that ``bench.py`` needs against XLA's common-subexpression elimination and
its relay (``bench.py:147-197``, ``:262-279``) is not needed.

Prints one JSON line on stdout with ``bench.py``'s keys (``bench.py:882-
913``) and ``breakdown_ms.drive_tracked_frame``, the median
``SLAMSystem.process_frame`` time of the tracked frames of a 6-frame drive
at ``config/base.yaml``; logs to stderr.  Two keys keep ``bench.py``'s
names for other work: ``threaded_1chip_backend_added_ms`` and
``threaded_1chip_hidden_frac`` time a backend thread that runs the
keyframe edge and the BA round (refresh + cached solve), the work of
``SLAMSystem``'s backend thread, where ``bench.py:774-795`` runs the
keyframe edge alone; the two records' figures are not comparable.

Environment knobs, read as ``bench.py:20-30`` reads them: ``BENCH_SMALL=1``
(the tiny model at 96x128), ``BENCH_CHAIN`` (calls per stage, default 16),
``BENCH_CPU=1`` (the CPU; without it and without a card the run exits
non-zero), ``BENCH_RATES`` (default ``bench_rates.json``),
``BENCH_RATES_FORCE=1``, ``BENCH_KF_RATE`` (assumed, default 0.2),
``BENCH_GN_ITERS``, ``BENCH_BA_ITERS``, ``BENCH_BA_UNCACHED=1`` and
``BENCH_INT8_ENC`` (default 1, off under ``BENCH_SMALL``).

Run from the repository root:  python3 bench_torch.py
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import local_devices
from ..frame import Frame
from ..global_opt import _prep_and_solve_cached, _refresh_pre_rows
from ..inference import resize_img
from ..models.mast3r import MASt3RConfig
from ..models.quant import encode_int8, quantize_encoder_params
from ..ops import ba as ba_ops
from ..ops import gn
from ..ops import lie_sim3 as sim3
from ..ops.attention import flash_attention
from ..ops.matching import MatchingConfig, match_desc_global
from ..ops.pack import pack_rows
from ..pipeline import SLAMSystem
from ..retrieval.asmk import IVF, ASMKKernel, Codebook
from ..retrieval.model import RetrievalParams, prep_features
from ..testing import build_seeded_engine, drain_within, production_clip
from ..tracker import TrackerConfig, track_step
from ..utils.config import load_config

BASELINE_FPS = 15.0
IMG_HW, SMALL_HW = (384, 512), (96, 128)
# the longest a backend thread of the threaded figures may take to end,
# and the longest the drive's last backend rounds may take to drain
THREAD_DEADLINE_S = DRAIN_S = 300.0
# bench.py's backend BA: keyframes, edges (two-way rows 2 E), dirty edges
# a round refreshes
BA_KEYFRAMES, BA_EDGES, BA_DIRTY = 16, 32, 4
# the breakdown keys that are stage times (bench.py:918-921)
STAGE_KEYS = ("encode", "encode_bf16", "track", "create_frame_host",
              "kf_edge_reused", "retrieval_edge_sym", "retrieval_edge_sym2",
              "retrieval_edge_desc", "retrieval_ms", "kf_ba_solve")
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline",
               "tracked_fps_per_chip", "protocol_fps_assumed_rates",
               "protocol_fps_2chip", "breakdown_ms")
BREAKDOWN_KEYS = (
    "encode", "encode_bf16", "track", "create_frame_host", "kf_edge_reused",
    "retrieval_edge_sym", "retrieval_edge_sym2", "retrieval_edge_desc",
    "retrieval_edge_desc2", "retrieval_edge_mode", "desc_fallback_rate",
    "retrieval_ms", "kf_ba_solve", "kf_rate", "retrieval_edge_rate",
    "retrieval_accept_rate", "gn_iters", "ba_iters", "rates_src",
    "int8_encoder", "threaded_1chip_backend_added_ms",
    "threaded_1chip_hidden_frac", "drive_tracked_frame")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Knobs(NamedTuple):
    """The environment knobs of ``bench.py:20-30``."""
    small: bool
    chain: int
    cpu: bool
    rates_path: str
    rates_force: bool
    kf_rate: float
    gn_iters: int      # 0: from the rates file
    ba_iters: int      # 0: from the rates file
    ba_uncached: bool
    int8_encoder: bool

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env
        small = env.get("BENCH_SMALL") == "1"
        return cls(
            small=small,
            chain=int(env.get("BENCH_CHAIN", "16")),
            cpu=env.get("BENCH_CPU") == "1",
            rates_path=env.get("BENCH_RATES", "bench_rates.json"),
            rates_force=env.get("BENCH_RATES_FORCE") == "1",
            kf_rate=float(env.get("BENCH_KF_RATE", "0.2")),
            gn_iters=int(env.get("BENCH_GN_ITERS", "0")),
            ba_iters=int(env.get("BENCH_BA_ITERS", "0")),
            ba_uncached=env.get("BENCH_BA_UNCACHED") == "1",
            # bench.py:206-207
            int8_encoder=env.get("BENCH_INT8_ENC", "1") == "1" and not small,
        )


class Rates(NamedTuple):
    """What the protocol composition reads from a rates file."""
    gn_iters: int
    ba_iters: int
    kf_rate: float
    retrieval_edge_rate: float     # proposals per frame: the cost weight
    retrieval_accept_rate: float   # accepted edges per frame
    desc_fallback_rate: float
    src: str                       # the file, or "assumed"


def load_rates(path, force: bool, kf_rate: float = 0.2, gn_iters: int = 0,
               ba_iters: int = 0) -> Rates:
    """The GN and BA iteration cadence (``bench.py:111-138``) and the
    protocol rates (``:632-690``) from the rates file at ``path``.

    The cadence reads the file unless it was measured under
    ``reference_exact``: GN iterations ``round(mean_gn_iters)`` (50 without
    it), BA iterations ``round(mean_ba_iters)`` (10 without it); non-zero
    ``gn_iters`` / ``ba_iters`` override.  The rates are refused, leaving
    the assumed ``kf_rate`` and no retrieval, when the file was measured
    under ``reference_exact``, has fewer than 100 frames, or had retrieval
    structurally absent (no ``retrieval_active`` and a proposal rate of
    0); ``force`` overrides the last two."""
    mj = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                mj = json.load(f)
            if mj.get("reference_exact"):
                mj = {}
        except (OSError, ValueError, AttributeError):
            mj = {}
    if not gn_iters:
        gn_iters = 50
        if mj.get("mean_gn_iters"):
            gn_iters = max(1, round(float(mj["mean_gn_iters"])))
    if not ba_iters:
        ba_iters = 10
        if mj.get("mean_ba_iters"):
            ba_iters = max(1, round(float(mj["mean_ba_iters"])))
    log(f"  GN iterations per track step: {gn_iters} (measured cadence; cap "
        f"50; BENCH_GN_ITERS overrides); BA iterations per solve: "
        f"{ba_iters} (cap 10; BENCH_BA_ITERS)")

    retr = accept = fb = 0.0
    src = "assumed"
    if os.path.exists(path):
        try:
            with open(path) as f:
                measured = json.load(f)
            kf_m = float(measured["kf_rate"])
            retr_m = float(measured.get("retrieval_proposal_rate",
                                        measured["retrieval_edge_rate"]))
            accept_m = float(measured["retrieval_edge_rate"])
            frames_m = int(measured.get("frames", 0))
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            log(f"  WARNING: rates file {path} unreadable/invalid ({e!r}); "
                f"using assumed rates")
            measured = None
        if measured is not None:
            log(f"  protocol rates measured ({path}, {frames_m} frames, "
                f"config={measured.get('config', '?')}, "
                f"dataset={measured.get('dataset', '?')}, "
                f"retrieval_active="
                f"{measured.get('retrieval_active', False)}): "
                f"kf_rate={kf_m:.3f} (assumed {kf_rate}), "
                f"retrieval_proposal_rate={retr_m:.3f}, "
                f"accepted_edge_rate={accept_m:.3f}")
            reject = None
            if measured.get("reference_exact"):
                reject = "measured under reference_exact"
            elif frames_m < 100 and not force:
                reject = (f"only {frames_m} frames (<100): a test-fixture "
                          f"clip, not a protocol run")
            elif (not measured.get("retrieval_active") and retr_m == 0.0
                  and not force):
                reject = ("retrieval was structurally absent (rate 0.0 is "
                          "not a measurement)")
            if reject:
                log(f"  WARNING: ignoring rates file: {reject}; using "
                    f"assumed rates (BENCH_RATES_FORCE=1 overrides)")
            else:
                kf_rate, retr, accept, src = kf_m, retr_m, accept_m, \
                    str(path)
                try:
                    fb = float(measured.get("desc_fallback_rate", 0.0))
                except (TypeError, ValueError):
                    fb = 0.0
    return Rates(gn_iters, ba_iters, kf_rate, retr, accept, fb, src)


def compose_protocol(breakdown: dict, rates: dict, edge_mode: str) -> dict:
    """The protocol rate of ``bench.py:689-735`` from stage times
    ``breakdown`` (ms, its keys) and ``rates`` (``kf_rate``,
    ``retrieval_edge_rate``, ``desc_fallback_rate``, ``kf_rate_assumed``).

    A frame costs the larger of the device frame (encode + track) and the
    host's frame preparation, which runs on the prefetch thread beside it;
    each keyframe adds the pose-warped edge, the BA round and the retrieval
    update; each retrieval proposal adds its edge: under ``desc_global``
    the pose-free match plus the symmetric fallback at its rate, else the
    symmetric decode + match, batched per keyframe round (the marginal edge
    of the two-edge batch) when a round averages more than one proposal.
    Returns ``protocol_ms``, ``protocol_fps``, ``protocol_fps_assumed``
    (the assumed keyframe rate, no retrieval), ``sym_frame_ms`` and
    ``frame_ms``."""
    b = breakdown
    kf_rate = rates["kf_rate"]
    retr = rates["retrieval_edge_rate"]
    frame_ms = b["encode"] + b["track"]
    host_ms = b["create_frame_host"]
    sym_ms = b["retrieval_edge_sym"]
    marg_ms = max(b["retrieval_edge_sym2"] - sym_ms, 0.0)
    e_mean = retr / kf_rate if kf_rate > 0 else 0.0
    if edge_mode == "desc_global":
        sym_frame_ms = retr * (b["retrieval_edge_desc"]
                               + rates["desc_fallback_rate"] * sym_ms)
    elif e_mean > 1.0:
        sym_frame_ms = kf_rate * (sym_ms + (e_mean - 1.0) * marg_ms)
    else:
        sym_frame_ms = retr * sym_ms
    kf_ms = b["kf_edge_reused"] + b["kf_ba_solve"] + b["retrieval_ms"]
    protocol_ms = max(frame_ms, host_ms) + kf_rate * kf_ms + sym_frame_ms
    assumed_ms = max(frame_ms, host_ms) + rates["kf_rate_assumed"] * kf_ms
    return {"protocol_ms": protocol_ms, "protocol_fps": 1e3 / protocol_ms,
            "protocol_fps_assumed": 1e3 / assumed_ms,
            "sym_frame_ms": sym_frame_ms, "frame_ms": frame_ms}


def check_record(rec: dict, kf_rate_assumed: float = 0.2) -> dict:
    """Hold a printed record to what it must say: ``bench.py``'s keys and
    ``drive_tracked_frame``; every stage positive; ``tracked_fps_per_chip``
    1000 / (encode + track), ``vs_baseline`` value / 15, ``value``
    ``compose_protocol`` of the printed breakdown and rates and
    ``protocol_fps_assumed_rates`` its figure at ``kf_rate_assumed``
    (``BENCH_KF_RATE``), each to the rounding of the printed figures
    (stages to 0.005 ms, the fallback rate to 5e-4, the rates of frames to
    5e-4).  Raises ``ValueError`` naming what fails; returns the
    recomposed protocol."""
    if tuple(rec) != RECORD_KEYS or \
            tuple(rec["breakdown_ms"]) != BREAKDOWN_KEYS:
        raise ValueError(f"record keys {list(rec)} / "
                         f"{list(rec.get('breakdown_ms', {}))}")
    b = rec["breakdown_ms"]
    bad = [k for k in STAGE_KEYS + ("retrieval_edge_desc2",)
           if not b[k] > 0]
    if b["drive_tracked_frame"] is not None and \
            not b["drive_tracked_frame"] > 0:
        bad.append("drive_tracked_frame")
    if bad:
        raise ValueError(f"non-positive stages {bad}")
    frame = b["encode"] + b["track"]
    fps = 1e3 / frame
    if abs(rec["tracked_fps_per_chip"] - fps) > 5e-4 + fps * 0.01 / frame:
        raise ValueError(f"tracked_fps_per_chip {rec['tracked_fps_per_chip']}"
                         f" against 1000 / (encode + track) {fps}")
    rates = {"kf_rate": b["kf_rate"],
             "retrieval_edge_rate": b["retrieval_edge_rate"],
             "desc_fallback_rate": b["desc_fallback_rate"],
             "kf_rate_assumed": kf_rate_assumed}
    proto = compose_protocol(b, rates, b["retrieval_edge_mode"])
    kf, retr = rates["kf_rate"], rates["retrieval_edge_rate"]
    e_mean = retr / kf if kf > 0 else 0.0
    # every coefficient a printed stage can have in the composition, times
    # its rounding, and the fallback rate's rounding
    weight = 2 + 3 * kf + retr * (2 + rates["desc_fallback_rate"]) \
        + kf * (abs(2 - e_mean) + e_mean)
    err_ms = 0.005 * weight + retr * b["retrieval_edge_sym"] * 5e-4
    p = proto["protocol_fps"]
    if abs(rec["value"] - p) > 5e-4 + p * p * err_ms / 1e3:
        raise ValueError(f"value {rec['value']} against the composition "
                         f"of the printed stages {p}")
    pa = proto["protocol_fps_assumed"]
    err_ms = 0.005 * (2 + 3 * kf_rate_assumed)
    if abs(rec["protocol_fps_assumed_rates"] - pa) > \
            5e-4 + pa * pa * err_ms / 1e3:
        raise ValueError(f"protocol_fps_assumed_rates "
                         f"{rec['protocol_fps_assumed_rates']} against the "
                         f"composition at kf_rate {kf_rate_assumed} {pa}")
    if abs(rec["vs_baseline"] - rec["value"] / BASELINE_FPS) > 1e-3:
        raise ValueError(f"vs_baseline {rec['vs_baseline']} against value "
                         f"/ {BASELINE_FPS}")
    return proto


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_busy(fn, dev, top=0, out=None):
    """The summed device time (ms) of the kernels of one traced call of
    ``fn`` (``torch.profiler``) and their number, printing the ``top``
    kernels by time to ``out`` (stderr).  Kernels of one stream do not
    overlap, so the sum is the busy time.  (None, 0) on the CPU or when the
    profiler sees no device time."""
    if dev.type != "cuda":
        return None, 0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        return None, 0
    for ms, n, key in rows[:top]:
        print(f"  kernel {ms:8.3f} ms {n:5d}x {key[:90]}",
              file=out or sys.stderr)
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def timed(fn, reps: int, label: str, dev, stages: dict):
    """The median host-clock ms of ``reps`` calls of ``fn`` after 2
    warm-up calls, each call between two synchronizes of ``dev``.  Logs the
    same calls' CUDA-event ms and one traced call's device busy ms beside
    it (on the card), and records all three in ``stages[label]``.  A
    non-positive time is refused, as ``bench.py:187-197`` refuses it."""
    for _ in range(2):
        fn()
    cuda = dev.type == "cuda"
    host, events = [], []
    for _ in range(reps):
        _sync(dev)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            e0.record()
        fn()
        if cuda:
            e1.record()
        _sync(dev)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            events.append(e0.elapsed_time(e1))
    ms = statistics.median(host)
    if not ms > 0:
        raise RuntimeError(f"bench stage '{label}' non-positive ({ms} ms): "
                           f"refusing to emit a corrupted record")
    ev_ms = statistics.median(events) if events else None
    busy_ms, kernels = device_busy(fn, dev)
    log(f"  {label}: {ms:.3f} ms on the host clock (median of {reps}, "
        f"range {min(host):.3f}-{max(host):.3f}); CUDA events "
        f"{'not measured' if ev_ms is None else f'{ev_ms:.3f} ms'}; device "
        f"busy {'not measured' if busy_ms is None else f'{busy_ms:.3f} ms'}"
        f" in {kernels} kernels (one traced call)")
    stages[label] = {"host_ms": ms, "event_ms": ev_ms, "busy_ms": busy_ms,
                     "kernels": kernels}
    return ms


def bench_matching_config():
    """``bench.py:95-104``: accept-everything gates (random weights would
    otherwise gate out the points and let the solve stop early) with the
    production subsampling of ``config/base.yaml``."""
    return MatchingConfig(dist_thresh=1e9, coarse_subsample=2,
                          final_radius=1, coarse_radius=2,
                          dilation_schedule=(4, 2), lm_subsample=4,
                          occlusion_subsample=2, edge_query_subsample=2)


def bench_tracker_config(gn_iters: int):
    """``bench.py:139-140``: every point in, no convergence exit, so the
    solve runs exactly ``gn_iters`` iterations."""
    return TrackerConfig(C_conf=-1e9, Q_conf=-1e9, rel_error=0.0,
                         delta_norm=0.0, max_iters=gn_iters)


def track_inputs(engine, img):
    """The track stage's keyframe (``img``'s encode and mono decode) and
    frame (the keyframe's features + 0.01), as ``bench.py:240-252``
    builds them, and the identity match initialisation."""
    dev = engine.device
    h, w = engine.img_hw
    feat, pos = engine.encode(img)
    X, C = engine.inference_mono(feat, pos)

    def frame(**kw):
        base = dict(
            frame_id=torch.zeros((), dtype=torch.int32, device=dev),
            uimg=torch.zeros((h, w, 3), dtype=torch.uint8, device=dev),
            T_WC=sim3.identity(device=dev),
            X_canon=torch.zeros((h * w, 3), device=dev),
            C=torch.zeros((h * w, 1), device=dev), feat=feat[0], pos=pos[0],
            N=torch.zeros((), dtype=torch.int32, device=dev),
            N_updates=torch.zeros((), dtype=torch.int32, device=dev),
            score=torch.zeros((), device=dev))
        base.update(kw)
        return Frame(**base)

    one = torch.ones((), dtype=torch.int32, device=dev)
    kf = frame(X_canon=X[0], C=C[0], N=one, N_updates=one)
    frame0 = frame(feat=feat[0] + 0.01)
    idx0 = torch.arange(h * w, device=dev)[None]
    return frame0, kf, idx0


def ba_problem(h: int, w: int, dev, bacfg):
    """``bench.py:406-437``: 16 keyframes holding one base cloud under their
    own random pixel permutations, 32 edges two-way (64 rows) whose matches
    map each pixel to the same 3D point (a consistent system that the
    solve does not leave early), and the pregather cache of
    ``global_opt``, its rows for every edge built."""
    P, E, R = BA_KEYFRAMES, BA_EDGES, BA_DIRTY
    hw = h * w
    rng = np.random.default_rng(0)
    base = rng.standard_normal((hw, 3)).astype(np.float32)
    base[:, 2] += 4.0
    sig = np.stack([rng.permutation(hw) for _ in range(P)])
    inv = np.argsort(sig, axis=1)
    ii2 = np.concatenate([np.arange(E) % (P - 1), np.arange(E) % (P - 1) + 1])
    jj2 = np.concatenate([np.arange(E) % (P - 1) + 1, np.arange(E) % (P - 1)])
    p = {
        "Xs": torch.from_numpy(base[sig]).to(dev),
        "Cs": torch.full((P, hw), 10.0, device=dev),
        "N": torch.ones((P,), dtype=torch.int32, device=dev),
        "ii2": torch.from_numpy(ii2).to(dev),
        "jj2": torch.from_numpy(jj2).to(dev),
        "idx2": torch.from_numpy(
            inv[ii2[:, None], sig[jj2]].astype(np.int32)).to(dev),
        "vm2": torch.ones((2 * E, hw), dtype=torch.bool, device=dev),
        "Q2": torch.full((2 * E, hw), 4.0, device=dev),
        "ev": torch.ones((2 * E,), dtype=torch.bool, device=dev),
        "Twc": sim3.identity((P,), device=dev),
        "K": torch.eye(3, device=dev),
        "uidx": torch.arange(P, device=dev),
    }
    s = max(int(bacfg.points_subsample), 1)
    n_sub = -(-hw // s)
    C = min(bacfg.chunk_points, hw)
    Np = n_sub + (-n_sub % C)
    pres = tuple(torch.zeros(shape, dtype=dt, device=dev)
                 for shape, dt in (((E, 3, Np), torch.float32),
                                   ((E, Np), torch.float32),
                                   ((E, Np), torch.int32)) * 2)
    # one direction of the store, used for both (bench.py:492-509)
    stores = (p["idx2"][:E],) * 2 + (p["vm2"][:E],) * 2 + (p["Q2"][:E],) * 2
    p.update(pres=pres, stores=stores)

    def refresh(lo, n_kf):
        # the R edges from slot lo: their endpoints in a compact set of
        # n_kf keyframes (bench.py:497-499, 521-527)
        ii_l = p["ii2"][lo:lo + R]
        jj_l = p["jj2"][lo:lo + R]
        _refresh_pre_rows(pres, p["Xs"], p["Cs"][..., None], p["N"], p["K"],
                          stores, torch.arange(lo, lo + R, device=dev),
                          torch.arange(n_kf, device=dev), ii_l, jj_l,
                          (w, h), bacfg, False)

    p["refresh"] = refresh
    for lo in range(0, E, R):
        refresh(lo, P)
    return p


class _Bench:
    """The stages of one run: inputs built once, one callable each."""

    def __init__(self, knobs: Knobs, dev, rates: Rates):
        self.knobs, self.dev = knobs, dev
        if knobs.small:
            self.mcfg = MASt3RConfig.tiny()
            self.hw = SMALL_HW
        else:
            self.mcfg = MASt3RConfig.vit_large(head_dtype=torch.bfloat16)
            self.hw = IMG_HW
        log(f"bench: device={dev}"
            + (f" ({torch.cuda.get_device_name(dev)})"
               if dev.type == "cuda" else "")
            + f" model={'tiny' if knobs.small else 'vit-large'} "
            f"res={self.hw[0]}x{self.hw[1]} chain={knobs.chain}")
        t0 = time.perf_counter()
        self.engine, _ = build_seeded_engine(
            self.mcfg, self.hw, 0, device=dev,
            match_cfg=bench_matching_config())
        log(f"  network built in {time.perf_counter() - t0:.1f} s")
        self.cfg = load_config("config/base.yaml")
        lo = self.cfg["local_opt"]
        self.edge_mode = str(lo.get("retrieval_edge_mode", "sym"))
        self.bacfg = ba_ops.BAConfig(
            delta_norm=0.0, max_iters=rates.ba_iters,
            points_subsample=int(lo.get("points_subsample", 1)))
        self.tcfg = bench_tracker_config(rates.gn_iters)
        gen = torch.Generator().manual_seed(1)
        self.img = torch.randn((1, *self.hw, 3), generator=gen).to(dev)
        self.qparams = None
        if knobs.int8_encoder:
            self.qparams = quantize_encoder_params(self.engine.model)

    # -- the frame --------------------------------------------------------

    def encode_bf16(self):
        return self.engine.encode(self.img)

    def encode_int8(self):
        return encode_int8(self.engine.model, self.qparams, self.img)

    def encode(self):
        return self.encode_int8() if self.qparams is not None else \
            self.encode_bf16()

    def track_setup(self):
        self.frame0, self.kf, self.idx0 = track_inputs(self.engine,
                                                       self.img)

    def track(self, frame=None):
        res = track_step(self.engine,
                         self.frame0 if frame is None else frame, self.kf,
                         self.idx0, self.tcfg)
        if res.gn_iters != self.tcfg.max_iters:
            raise RuntimeError(
                f"the track stage's solve ran {res.gn_iters} GN iterations, "
                f"not {self.tcfg.max_iters} (ok={res.ok}): its time would "
                f"not be the cadence's")
        return res

    def frame_step(self):
        """One whole tracked frame: the headline's encode, then the track
        step on its features."""
        feat, pos = self.encode()
        return self.track(self.frame0.replace(feat=feat[0] + 0.01,
                                              pos=pos[0]))

    # -- the keyframe's edges ---------------------------------------------

    def sym_setup(self):
        feat, pos = self.engine.encode(self.img)
        self.sym1 = (feat, pos, feat + 0.01, pos)
        f2 = torch.cat([feat, feat + 0.02])
        p2 = torch.cat([pos, pos])
        self.sym2 = (f2, p2, f2 + 0.01, p2)

    def desc_setup(self):
        h, w = self.hw
        gen = torch.Generator().manual_seed(7)
        D8a, D8b = (torch.randint(-127, 128, (1, h, w, 24), generator=gen,
                                  dtype=torch.int8).to(self.dev)
                    for _ in range(2))
        dc = torch.ones((1, h * w, 1), device=self.dev)
        self.desc1 = (D8a, D8b, dc, dc)
        self.desc2 = (torch.cat([D8a, D8b]), torch.cat([D8b, D8a]),
                      torch.cat([dc, dc]), torch.cat([dc, dc]))

    def desc(self, args):
        h, w = self.hw
        return match_desc_global(*args, h, w, cfg=self.engine.match_cfg)

    def kf_edge_setup(self, dev=None):
        """``bench.py:377-382``: keyframe i's points, keyframe j the same
        points under a small Sim(3) (so the warp has real work), random q8
        tables; as the arena rows ``match_arrays_warp`` reads."""
        dev = dev or self.dev
        h, w = self.hw
        gen = torch.Generator().manual_seed(4)
        X = torch.randn((h * w, 3), generator=gen) + torch.tensor(
            [0.0, 0.0, 3.0])
        T_sm = sim3.exp(torch.tensor([0.02, -0.01, 0.01, 0.01, -0.01, 0.02,
                                      0.0]))
        D = [torch.randint(-127, 128, (1, h * w, 24), generator=gen,
                           dtype=torch.int8) for _ in range(2)]
        return (torch.stack([X, X]).to(dev),
                torch.stack([sim3.identity(), T_sm]).to(dev),
                D[0].to(dev), D[1].to(dev))

    def kf_edge(self, args):
        X_arena, T_arena, D11, D21 = args
        return self.engine.match_arrays_warp(X_arena, T_arena, 0, 1, D11,
                                             D21, self.hw)

    # -- the BA round -----------------------------------------------------

    def ba_setup(self):
        h, w = self.hw
        self.ba = ba_problem(h, w, self.dev, self.bacfg)

    def ba_refresh(self):
        self.ba["refresh"](0, 2 * BA_DIRTY)

    def ba_solve(self):
        p, h, w = self.ba, *self.hw
        if self.knobs.ba_uncached:
            out = ba_ops.gauss_newton(
                p["Twc"], p["Xs"], p["Cs"], p["ii2"], p["jj2"], p["idx2"],
                p["vm2"], p["Q2"], p["ev"], p["K"], "ray", (w, h),
                self.bacfg)
        else:
            out = _prep_and_solve_cached(
                p["Xs"], p["Twc"], *p["pres"], p["uidx"], p["ii2"],
                p["jj2"], p["K"], BA_EDGES, "ray", (w, h), self.bacfg,
                False)
        if out[1] != self.bacfg.max_iters:
            raise RuntimeError(f"the BA solve ran {out[1]} iterations, not "
                               f"{self.bacfg.max_iters} (ok={out[3]})")
        return out

    def ba_round(self):
        if not self.knobs.ba_uncached:
            self.ba_refresh()
        return self.ba_solve()

    # -- retrieval --------------------------------------------------------

    def retrieval_setup(self):
        """``bench.py:570-620``: a random head and codebook (65,536 words,
        4,096 under ``BENCH_SMALL``) and an IVF populated to 300 keyframes
        (64)."""
        small = self.knobs.small
        cb_size, dim, nfeat = (4096 if small else 65536), 128, 300
        d = self.mcfg.enc_embed_dim
        self.rp = RetrievalParams.random(d_in=d, hdims=(d, dim),
                                         seed=2).to(self.dev)
        rng = np.random.default_rng(3)
        self.cb = Codebook(rng.standard_normal((cb_size, dim))
                           .astype(np.float32), device=self.dev)
        n_tok = self.engine.n_patches
        self.nfeat = min(nfeat, n_tok)
        gen = torch.Generator().manual_seed(4)
        self.toks = torch.randn((1, n_tok, d), generator=gen).to(self.dev)
        self.kern = ASMKKernel(self.cb, binary=True)
        self.ivf = IVF(cb_size)
        self.n_kf_ivf = 64 if small else 300
        self.feats_np = rng.standard_normal(
            (self.n_kf_ivf + 1, self.nfeat, dim)).astype(np.float32)
        self.words_np = rng.integers(
            0, cb_size, (self.n_kf_ivf + 1, self.nfeat, 5)).astype(np.int32)
        for i in range(self.n_kf_ivf):
            ad, wi = self.kern.aggregate_image(self.feats_np[i],
                                               self.words_np[i, :, :1])
            self.ivf.add(ad, wi, np.full(len(wi), i, np.int64))

    def retrieval_device(self):
        top = prep_features(self.rp, self.toks, self.nfeat,
                            residual=bool(self.rp.residual))
        return self.cb.quantize(top[0], 5)

    def retrieval_host(self):
        i = self.n_kf_ivf
        f, wds = self.feats_np[i], self.words_np[i]
        ad, wi = self.kern.aggregate_image(f, wds)
        self.ivf.search_packed(ad, wi, self.cb.dim, alpha=3.0,
                               similarity_threshold=0.0)
        ad1, wi1 = self.kern.aggregate_image(f, wds[:, :1])
        self.ivf.add(ad1, wi1, np.full(len(wi1), i, np.int64))


def create_frame_host_ms(reps: int = 20) -> float:
    """``bench.py:547-561``: the host's resize + normalise of a 480x640
    frame, mean of ``reps`` calls after one warm-up."""
    rgb = (np.random.default_rng(0).random((480, 640, 3)) * 255).astype(
        np.uint8)
    resize_img(rgb, 512)
    t0 = time.perf_counter()
    for _ in range(reps):
        resize_img(rgb, 512)
    return (time.perf_counter() - t0) / reps * 1e3


def run_with_thread(front, n_front: int, back, n_back: int, dev,
                    back_dev=None) -> float:
    """Wall ms per front call of ``n_front`` calls of ``front`` on this
    thread while a Python thread makes ``n_back`` calls of ``back`` (none
    when ``n_back`` is 0), as ``SLAMSystem``'s backend thread shares the
    stream: the thread runs on the stream current here when it starts
    (``back_dev``: that card's current stream instead).  The thread's end
    has a deadline; its error is raised here."""
    errors = []
    stream = None
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(back_dev or dev)

    def backend():
        try:
            if stream is None:
                for _ in range(n_back):
                    back()
                return
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                for _ in range(n_back):
                    back()
        except BaseException as e:     # raised on the main thread below
            errors.append(e)

    _sync(dev)
    if back_dev is not None:
        _sync(back_dev)
    t0 = time.perf_counter()
    th = threading.Thread(target=backend, daemon=True, name="bench-backend")
    if n_back:
        th.start()
    for _ in range(n_front):
        front()
    if n_back:
        th.join(THREAD_DEADLINE_S)
        if th.is_alive():
            raise TimeoutError(f"the backend thread did not end within "
                               f"{THREAD_DEADLINE_S} s")
    _sync(dev)
    if back_dev is not None:
        _sync(back_dev)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall / n_front * 1e3


def drive_tracked_frame(b: _Bench, dev):
    """The median ``SLAMSystem.process_frame`` ms of the TRACKING frames of
    the 6-frame production clip (``testing.production_clip``, the clip of
    ``chip_smoke.py``'s drives) at ``config/base.yaml`` as written, through the
    engine ``main_torch.py`` builds by default (the bf16 encoder, the
    configuration's matcher), timed on the host clock as the frame loop
    sees it; None when no frame tracked."""

    engine = copy.copy(b.engine)
    engine.match_cfg = MatchingConfig.from_dict(b.cfg["matching"])
    frames = production_clip(0, b.hw)[:-1]
    system = SLAMSystem(b.cfg, engine, b.hw, device=dev)
    tracked, modes = [], []
    try:
        for i, img in enumerate(frames):
            t0 = time.perf_counter()
            info = system.process_frame(i, img)
            ms = (time.perf_counter() - t0) * 1e3
            modes.append(info["mode"])
            if info["mode"] == "TRACKING":
                tracked.append(ms)
        drain_within(system, DRAIN_S)
    finally:
        system.terminate()
    log(f"  drive ({len(frames)} frames, config/base.yaml): modes {modes}, "
        f"stats {dict(system.stats)}, tracked frames "
        f"{[round(t, 3) for t in tracked]} ms")
    return statistics.median(tracked) if tracked else None


def launches():
    """The kernel launches counted by ``_build.count_launch`` so far."""
    return {"attention": flash_attention.launches,
            "pack": pack_rows.launches, "gn_solve": gn.gn_solve.launches,
            "gn_accumulate": gn.gn_sums.launches}


def run(knobs: Knobs, dev) -> dict:
    """Every stage, the composition and the record."""
    N = knobs.chain
    rates = load_rates(knobs.rates_path, knobs.rates_force, knobs.kf_rate,
                       knobs.gn_iters, knobs.ba_iters)
    b = _Bench(knobs, dev, rates)
    stages: dict = {}

    def t(fn, label):
        return timed(fn, N, label, dev, stages)

    with torch.no_grad():
        enc_bf16_ms = t(b.encode_bf16, "encode_bf16")
        enc_ms = t(b.encode_int8, "encode") if knobs.int8_encoder \
            else enc_bf16_ms
        b.track_setup()
        track_ms = t(b.track, "track")
        frame_ms = enc_ms + track_ms
        fps = 1e3 / frame_ms
        variant = "int8" if knobs.int8_encoder else "bf16"
        log(f"frame: {enc_ms:.3f} (encode[{variant}]) + {track_ms:.3f} "
            f"(track) = {frame_ms:.3f} ms -> {fps:.3f} FPS (bf16 encoder "
            f"{enc_bf16_ms:.3f} ms)")

        b.sym_setup()
        sym_ms = t(lambda: b.engine.match_symmetric(*b.sym1),
                   "retrieval_edge_sym")
        sym2_ms = t(lambda: b.engine.match_symmetric(*b.sym2),
                    "retrieval_edge_sym2")
        b.desc_setup()
        mdg_ms = t(lambda: b.desc(b.desc1), "retrieval_edge_desc")
        mdg2_ms = t(lambda: b.desc(b.desc2), "retrieval_edge_desc2")
        kf_args = b.kf_edge_setup()
        kfedge_ms = t(lambda: b.kf_edge(kf_args), "kf_edge_reused")
        b.ba_setup()
        if knobs.ba_uncached:
            ba_ms = t(b.ba_solve, "kf_ba_solve")
        else:
            ba_ms = t(b.ba_refresh, "ba_refresh") + t(b.ba_solve,
                                                     "ba_cached_solve")
        host_ms = create_frame_host_ms()
        log(f"  create_frame host resize+norm: {host_ms:.3f} ms")
        b.retrieval_setup()
        retr_dev_ms = t(b.retrieval_device, "retrieval_device")
        b.retrieval_host()                      # warm
        t0 = time.perf_counter()
        for _ in range(10):
            b.retrieval_host()
        retr_host_ms = (time.perf_counter() - t0) / 10 * 1e3
        retrieval_ms = retr_dev_ms + retr_host_ms
        log(f"  retrieval stage: device {retr_dev_ms:.3f} + host (aggregate "
            f"+ search + add at {b.n_kf_ivf} keyframes) {retr_host_ms:.3f} "
            f"= {retrieval_ms:.3f} ms")

        breakdown = {
            "encode": enc_ms, "encode_bf16": enc_bf16_ms, "track": track_ms,
            "create_frame_host": host_ms, "kf_edge_reused": kfedge_ms,
            "retrieval_edge_sym": sym_ms, "retrieval_edge_sym2": sym2_ms,
            "retrieval_edge_desc": mdg_ms, "retrieval_edge_desc2": mdg2_ms,
            "retrieval_ms": retrieval_ms, "kf_ba_solve": ba_ms}
        rate_d = {"kf_rate": rates.kf_rate,
                  "retrieval_edge_rate": rates.retrieval_edge_rate,
                  "desc_fallback_rate": rates.desc_fallback_rate,
                  "kf_rate_assumed": knobs.kf_rate}
        proto = compose_protocol(breakdown, rate_d, b.edge_mode)
        log(f"protocol: max({frame_ms:.3f} encode+track, {host_ms:.3f} host)"
            f" + {rates.kf_rate:.3f}*({kfedge_ms:.3f} kf_edge + {ba_ms:.3f} "
            f"ba + {retrieval_ms:.3f} retrieval) + {proto['sym_frame_ms']:.3f}"
            f" {b.edge_mode} edges = {proto['protocol_ms']:.3f} ms -> "
            f"{proto['protocol_fps']:.3f} FPS (rates {rates.src})")

        # the backend's keyframe work on a Python thread beside the
        # frontend's frames (bench.py:742-799); the kf edge and the BA
        # round, where bench.py's thread runs the kf edge alone
        n_bk = max(1, round(N * rates.kf_rate))

        def back():
            b.kf_edge(kf_args)
            b.ba_round()

        w_front = run_with_thread(b.frame_step, N, back, 0, dev)
        w_pair = run_with_thread(b.frame_step, N, back, n_bk, dev)
        added_ms = max(w_pair - w_front, 0.0)
        back_alone_ms = (kfedge_ms + ba_ms) * n_bk / N
        hidden_frac = max(0.0, 1.0 - added_ms / max(back_alone_ms, 1e-9))
        log(f"  threaded-1chip: frontend {w_front:.3f} ms/frame, with the "
            f"backend thread (kf edge + BA, {n_bk} rounds over {N} frames) "
            f"{w_pair:.3f} "
            f"-> the backend adds {added_ms:.3f} of its {back_alone_ms:.3f} "
            f"ms/frame ({hidden_frac * 100:.1f}% hidden)")

        # the backend's edges on a second card (bench.py:807-880)
        protocol_fps_2chip = None
        cards = local_devices(dev.type) if dev.type == "cuda" else []
        if len(cards) >= 2:
            d1 = cards[1]
            kf_args1 = b.kf_edge_setup(d1)
            with torch.cuda.device(d1):
                b.kf_edge(kf_args1)             # warm the second card
            overlap_ms = run_with_thread(b.frame_step, N,
                                         lambda: b.kf_edge(kf_args1), n_bk,
                                         dev, back_dev=d1)
            p2_ms = max(overlap_ms, frame_ms, host_ms) \
                + rates.kf_rate * (ba_ms + retrieval_ms) \
                + proto["sym_frame_ms"]
            protocol_fps_2chip = 1e3 / p2_ms
            log(f"  2chip: frontend on {dev} with the kf_edge thread on "
                f"{d1}: {overlap_ms:.3f} ms/frame -> protocol {p2_ms:.3f} "
                f"ms = {protocol_fps_2chip:.3f} FPS")
        else:
            log("  2chip: skipped (one card; the stage runs with two)")

    drive_ms = drive_tracked_frame(b, dev)
    if drive_ms is None and not knobs.small:
        raise RuntimeError("the production drive tracked no frame")

    record = {
        "metric": "protocol_fps_per_chip",
        "value": round(proto["protocol_fps"], 3),
        "unit": "frames/s",
        "vs_baseline": round(proto["protocol_fps"] / BASELINE_FPS, 3),
        "tracked_fps_per_chip": round(fps, 3),
        "protocol_fps_assumed_rates": round(proto["protocol_fps_assumed"], 3),
        "protocol_fps_2chip": (round(protocol_fps_2chip, 3)
                               if protocol_fps_2chip else None),
        "breakdown_ms": {
            "encode": round(enc_ms, 2),
            "encode_bf16": round(enc_bf16_ms, 2),
            "track": round(track_ms, 2),
            "create_frame_host": round(host_ms, 2),
            "kf_edge_reused": round(kfedge_ms, 2),
            "retrieval_edge_sym": round(sym_ms, 2),
            "retrieval_edge_sym2": round(sym2_ms, 2),
            "retrieval_edge_desc": round(mdg_ms, 2),
            "retrieval_edge_desc2": round(mdg2_ms, 2),
            "retrieval_edge_mode": b.edge_mode,
            "desc_fallback_rate": round(rates.desc_fallback_rate, 3),
            "retrieval_ms": round(retrieval_ms, 2),
            "kf_ba_solve": round(ba_ms, 2),
            "kf_rate": rates.kf_rate,
            "retrieval_edge_rate": rates.retrieval_edge_rate,
            "retrieval_accept_rate": rates.retrieval_accept_rate,
            "gn_iters": rates.gn_iters,
            "ba_iters": rates.ba_iters,
            "rates_src": rates.src,
            "int8_encoder": knobs.int8_encoder,
            "threaded_1chip_backend_added_ms": round(added_ms, 2),
            "threaded_1chip_hidden_frac": round(hidden_frac, 3),
            "drive_tracked_frame": (None if drive_ms is None
                                    else round(drive_ms, 2)),
        },
    }
    # bench.py:916-926: a non-positive stage time is impossible
    bad = {k: record["breakdown_ms"][k] for k in STAGE_KEYS
           if record["breakdown_ms"].get(k, 1) <= 0}
    if bad:
        raise RuntimeError(f"non-positive stage times {bad}: refusing to "
                           f"emit a corrupted bench record")
    log("stages (host ms, CUDA-event ms, busy ms, kernels): "
        + json.dumps(stages))
    return record


def main(env=None) -> int:
    knobs = Knobs.from_env(env)
    if not knobs.cpu and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (BENCH_CPU=1 runs on the CPU)",
              file=sys.stderr)
        return 1
    if knobs.chain < 1:
        print(f"bench_torch: BENCH_CHAIN must be >= 1, got {knobs.chain}",
              file=sys.stderr)
        return 1
    dev = torch.device("cpu") if knobs.cpu else \
        torch.device("cuda", torch.cuda.current_device())
    record = run(knobs, dev)
    n = launches()
    log("bench_torch: launches " + " ".join(f"{k} {v}" for k, v in n.items()))
    print(json.dumps(record), flush=True)
    return 0
