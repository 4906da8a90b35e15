#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``mast3r_slam_torch/csrc`` (attention
on the tensor cores, the GN accumulation and the whole GN solve in one
launch, the probe-table pack), holds each against its plain PyTorch version
on the card at the shapes the main path gives it, and times it beside its
bound, its plain version and (where one exists) a single PyTorch library
call.  Then it drives the port as a user would:

* the network's heads: a small model's f32 and bf16 heads on the card
  against the CPU, then ViT-L bf16 heads against f32 heads of the same
  weights, with decode + heads timed in both dtypes;
* ``main_torch.run`` (the frame loop of ``main_torch.py``) at full ViT-L
  width on 384x512 frames with seeded random weights, bf16 heads (as
  ``main_torch.py`` runs them by default) and ``config/base.yaml``
  unmodified (the production matcher; the backend on its thread, the
  consecutive edge pose-warped without a decode), counting that every
  attention, GN solve and table pack of that drive, the backend thread's
  included, went through the kernels, and writing and reading back the
  trajectory; its end state saved with ``--state-out`` and loaded into a
  fresh system, bitwise, with the file's bytes and the save and load
  seconds; the same frames again with ``single_thread: True``, frame,
  keyframe-frame and drive times side by side;
* the last backend round's BA inputs solved again on the CPU and held
  against the card's solve;
* the same drive with ``reference_exact: true`` (the full-resolution
  matcher, the per-component Huber solve, consecutive edges through the
  symmetric decode + match);
* ``main_torch.run`` again at the same width and configuration over a loop
  clip (out and back to the first image) with an ASMK retrieval database
  built by ``RetrievalDatabase.from_checkpoint`` from a forged head and a
  forged 65,536-word codebook: loop-closure proposals become
  ``desc_global`` edges matched from the stored q8 tables (kernel C packs
  4 tables a pair), rejected pairs go through the symmetric decode; then
  one pair's tables through ``match_desc_global`` on the card against the
  CPU, bitwise;
* the oracle harness (a rendered 16-frame clip with known poses),
  uncalibrated and calibrated, with the backend, scored by ATE and held
  against the same drive on the CPU; the 24-frame oracle loop clip
  with the oracle's q8 descriptors and retrieval database, on the card
  against the CPU; the 16-frame clip with the backend on its thread, with
  a drain after every frame against the inline run and free-running; the
  blackout clip relocalizing through the thread; and the 16-frame clip
  saved at frame 8, resumed and finished against the uninterrupted run;
* a stage breakdown of one tracking step and of the backend: a round's
  time, BA iterations, kernels per BA iteration, and the frame time of a
  keyframe against a plain tracked frame; and ``--profile-blocks``'
  per-sub-block breakdown of the ViT-L network (``utils/breakdown.py``)
  beside the measured encode and decode stages;
* the int8 path (``main_quantized_torch.py``, ``models/quant.py``): the
  quantised weights on the card against the CPU's, bitwise; the int32
  accumulators of the six int8 products of the main path against the
  CPU's, bitwise, each product timed beside the bf16 ``Dense`` of its
  shape and their bounds; the ViT-L int8 encode against bf16 (cosine,
  relative error, time, device busy) and a small model's on the card
  against the CPU; one decode with the int8 local-feature head against the
  bf16 heads; and ``main_torch.run`` over the production drive's frames
  with the int8 encoder, threaded, its launches counted as the production
  drive's and its frame times and poses beside the bf16 drive's;
* multi-GPU on the one card, every mesh entry that card: the ViT-L engine
  split over a (1, 2) mesh (``--tp 2``) against the unsplit one (encode
  and decode + heads, cosine and relative error of each output, kernel A
  launched once per block and entry, both engines timed in turns), kernel
  A at the split heads' shapes beside SDPA, and ``main_torch.run`` over the
  production frames with the split engine; the BA sharded over 2 entries
  (``FactorGraph(mesh=)``, edge and map) against the single-device solve
  on the oracle drive's graph and on the production drive's last round
  (its reduced (H, g)); the backend on device 0 (``backend_device=0``, its
  mirror arena beside the live one): the oracle drive against the drive
  without it, and the production drive threaded in turns with the
  threaded drive without it, the rows copied to the mirror counted;
* the live viewer (``main_torch.py`` without ``--no-viz``): the production
  drive with a ``viz_server.LiveViewer`` published at ``main.py``'s
  cadence, in turns with the threaded drive without it (viewer, without,
  without, viewer), a client thread reading ``/meta``, ``/cloud`` and
  ``/frame`` throughout; its launches must equal the production drive's;
  each publish timed with the rows and bytes it copied, the frame times,
  the frame after a keyframe and the loop's iterations side by side; the
  last served blob bitwise the one built from the arena's CPU copy, the
  world cloud and the snapshot on the card against that copy; pause and
  single step on the oracle clip; and ``dataset.img_downsample`` 2 on the
  ViT-L engine (decode outputs bitwise the strided full ones, one match at
  192x256 with kernel C's launches counted);
* a published checkpoint file: the conditioned ViT-L weights written as a
  MASt3R run saves them (``args`` Namespace, ``model`` state dict with
  ``dec_blocks2``, the DPT's ``layer_rn`` aliases and ``mask_token``),
  loaded through ``main_torch.load_model``: every tensor equal to the
  written ones, encode + ``decode_pair`` bitwise the production engine's;
  the file's bytes, write, read and load seconds;
* ``main_torch.main`` as a user runs it, from the production frames written
  as a PNG clip, with that checkpoint file and ``config/base.yaml``
  unmodified: its launches and stats must equal the in-memory production
  drive's, and its keyframe poses' largest difference from that drive is
  printed;
* the evaluation tools (``mast3r_slam_torch/tools``), each a process under
  a deadline: a synthetic clip written by ``make_synthetic_clip``,
  ``eval_protocol`` over it on the card and on the CPU (ATE within the
  oracle's card-against-CPU bound), ``analyze_drive`` on the card run's
  ``--diag-out``, and ``segmented_drive`` in 3 segments on the card against
  the one-process run;
* the tracked-FPS benchmark, ``bench_torch.py`` (``tools/bench.py``) as a
  process with 4 calls a stage: its record must carry ``bench.py``'s keys
  and ``drive_tracked_frame``, positive stages and a headline that is the
  composition of its printed stages and rates, and the process must have
  launched kernels A, C and ``gn_solve``.

Run from the repository root:  python3 chip_smoke.py [--seed N]
Exits non-zero, printing no result, when any phase fails, when the whole
run outlasts its deadline or no CUDA card is present.  The last line is
the JSON device record.
"""

from __future__ import annotations

import argparse
import copy
import faulthandler
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# Dense data-sheet peaks (bf16 tensor-core FLOP/s, device-memory bytes/s;
# int8 tensor-core OP/s) of the card the port runs on, by the name
# torch.cuda.get_device_name gives.
_PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}
_INT8_PEAKS = {"NVIDIA H100 80GB HBM3": 1979e12}

ATTN_SHAPES = [  # (B, H, Nq, Nk, Dh)
    (1, 16, 768, 768, 64),   # encoder self-attention, ViT-L 384x512
    (1, 12, 768, 768, 64),   # decoder self-attention
    (2, 3, 300, 300, 64),    # ragged N
    (1, 12, 768, 512, 64),   # cross-attention with Nq != Nk
]
ATTN_TOL = {"bf16": 2e-2, "f32": 1e-4}   # max abs error on N(0,1) inputs
ATTN_RAGGED = (1, 77, 768, 769)          # Nq and Nk of the strided bf16 check
GN_POSE_ATOL = 1e-5                      # gn_solve against the plain loop
IMG_HW = (384, 512)
# the retrieval drive's loop clip: frames out (then back to the first, in
# reverse), shift and texture (4 keyframes, 3 proposals in 2 desc_global
# batches on an H100), and the forged codebook's size (the published
# codebook's 64k words)
N_FRAMES_LOOP_OUT, LOOP_SHIFT, LOOP_TEXTURE = 9, 48, 0.7
CODEBOOK_WORDS = 65536
N_FRAMES_REFERENCE_EXACT = 6
# ATE limits of the oracle drives: those of tests/test_pipeline.py; and the
# card's oracle ATE against the same drive on the CPU
ORACLE_ATE_LIMIT = {"uncalibrated": 0.05, "calibrated": 0.1}
ORACLE_ATE_CPU_ATOL = 1e-5
# the threaded oracle drive with a drain per frame against the inline one,
# and a resumed oracle drive against the uninterrupted one, on the card:
# poses (both bitwise on the CPU, tests/test_torch_threading.py and
# tests/test_torch_state.py)
ORACLE_THREAD_ATOL = ORACLE_RESUME_ATOL = 1e-6
# the longest a drain may wait for the backend's queued rounds, and the
# whole script's deadline: a stuck round fails the run instead of hanging it
DRAIN_S, WATCHDOG_S = 300.0, 1150.0
# when the watchdog fires (time.monotonic()), set by main
_DEADLINE = [float("inf")]
# the card's BA against the CPU's on the same inputs: H and g of one
# iteration (relative to their largest entry; read 4.5e-7 and 2.8e-7 on an
# H100), and the whole solve's poses (read 1.8e-4; the drive's round does
# not converge)
BA_HG_RTOL, BA_POSE_ATOL = 4e-6, 1.5e-3
# the factor graph's edge arrays, in the order of FactorGraph._stores()
STORE = ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
         "Q_ii2jj", "Q_jj2ii")
# acceptance bounds of bf16 heads against a reference (tests/test_model.py)
HEAD_COS_MIN, HEAD_REL_DEPTH_MAX, HEAD_REL_CONF_MAX = 0.999, 0.02, 0.05
# the int8 encoder against the fp one and the int8 local head against the
# fp heads (tests/test_quant.py:29-32, 83-87); the small model's int8
# encode on the card against the CPU, of the features' scale (read 3.5e-2
# on features up to ~3 on an H100: 8.3e-3 of the scale); X and C of a
# decode with the int8 local head against the bf16 heads, of their scale
# (read 0: the same DPT on the same tokens)
INT8_COS_MIN, INT8_REL_MAX = 0.99, 0.15
INT8_DESC_COS_MIN, INT8_Q_REL_MAX = 0.99, 0.1
INT8_SMALL_TOL = 2e-2
INT8_XC_ATOL = 1e-5
# multi-GPU on the one card, every mesh entry that card.  Tensor parallel:
# ViT-L bf16 split over a (1, 2) mesh against the unsplit engine, each of
# feat, X, C, D, Q (cosine, relative L2 error; each bf16 partial sum is
# rounded once more than the unsplit product), and kernel A at the split
# heads' shapes (encoder 16 / 2, decoder 12 / 2 heads).  Sharded BA: the
# converged oracle graph against the single-device solve at the JAX test's
# 2e-4 with equal iterations; the production round's reduced (H, g) of one
# iteration at the card-against-CPU bound of check_ba.
# Backend device 0: the oracle drive against the same drive without it,
# JAX's test's 1e-5.  The tensor-parallel bounds are set from an H100's
# readings (1 - cosine <= 2.5e-5, relative error <= 7.1e-3, of D).
TP_COS_MIN, TP_REL_MAX = 0.9998, 0.02
TP_ATTN_SHAPES = {"encoder": (1, 8, 768, 768, 64),
                  "decoder": (1, 6, 768, 768, 64)}
SHARD_POSE_ATOL, SHARD_HG_RTOL = 2e-4, 4e-6
BDEV_POSE_ATOL = 1e-5
# the longest the NCCL processes of --cards N may take, each call
NCCL_DEADLINE_S = 180.0
# the live viewer: how often its client thread reads the endpoints, how
# long a pause / step wait may take and how long a frame that must not come
# is waited for; the card's world cloud against the CPU copy's (of the
# points' scale: the Sim(3) action's f32 rounding, its products fused or
# not) and the share of the snapshot's pixels that must agree
VIEWER_POLL_S, VIEWER_WAIT_S, VIEWER_HOLD_S = 0.1, 60.0, 0.5
VIEWER_CLOUD_RTOL, VIEWER_SNAPSHOT_AGREE = 1e-5, 0.999
# the evaluation tools' clip (frames, h, w: the size of the tools' CPU
# tests), the protocol frames of each of segmented_drive's 3 segments, and
# the longest one tool's process may take
EVAL_CLIP, EVAL_SEGMENT, TOOL_TIMEOUT_S = (48, 48, 64), 8, 240
# the benchmark's process (bench_torch.py): calls per stage (its default is
# 16; 4 keep the phase inside the script's time) and its deadline
BENCH_CHAIN, BENCH_TIMEOUT_S = 4, 420


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def peaks(name):
    if name not in _PEAKS:
        raise SystemExit(f"no data-sheet peaks for {name!r}: add its entry "
                         f"to _PEAKS")
    return _PEAKS[name]


def time_ms(fn, reps=50, warmup=5):
    """Device time of one call of ``fn`` in ms: ``reps`` calls between two
    CUDA events.  The calls are enqueued behind a spin kernel of some 10 ms,
    so that a call whose kernels are shorter than its launch on the host is
    timed by the card's work and not by the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def tensor_core_instructions():
    """The count of warpgroup (``HGMMA``) and warp (``HMMA``) matrix
    instructions in the SASS of the built attention library, by
    ``cuobjdump``: the proof that its products run on the tensor cores."""
    import shutil
    from pathlib import Path

    from mast3r_slam_torch import _build

    lib = _build.lib_path("attention")
    cands = [Path(_build.nvcc()).parent / "cuobjdump"]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((str(c) for c in cands if c.exists()),
                shutil.which("cuobjdump"))
    if tool is None:
        raise SystemExit("cuobjdump not found: cannot show that attention "
                         "runs on the tensor cores")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts = {op: sum(1 for line in sass.splitlines() if f" {op}." in line)
              for op in ("HGMMA", "HMMA")}
    print(f"attention SASS ({Path(tool).name} -sass {lib.name}): "
          f"{counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA instructions")
    if counts["HGMMA"] + counts["HMMA"] == 0:
        raise SystemExit("the attention library holds no tensor-core "
                         "instruction")
    return counts


def check_attention(peak_flops, peak_bw, card):
    """Kernel A against ``attention_plain``: the main path's shapes
    contiguous in bf16 and f32; then bf16 on strided views of (B, N, H, Dh)
    memory at ragged sizes, with a V whose columns carry distinct offsets
    (a wrong lane in the P fragment or the V descriptor moves a column);
    then q, k, v as the model's views of one packed qkv product.  Times
    kernel, plain version and SDPA on the same tensors."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import attention_plain, \
        flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def held(what, name, q, k, v):
        out = flash_attention(q, k, v)
        err = (out.float() - attention_plain(q, k, v).float()).abs().max() \
            .item()
        torch.cuda.synchronize()
        ok = err <= ATTN_TOL[name] and out.shape == q.shape \
            and out.transpose(1, 2).is_contiguous()
        print(f"attention {name} {what}: max abs err {err:.3e} (tol "
              f"{ATTN_TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("attention kernel disagrees with its plain "
                             "version")
        return err

    worst = {}
    for (B, H, Nq, Nk, Dh) in ATTN_SHAPES:
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v = (randn(B, H, n, Dh).to(dt) for n in (Nq, Nk, Nk))
            worst[(B, H, Nq, Nk, name)] = held(
                f"B={B} H={H} Nq={Nq} Nk={Nk} Dh={Dh}", name, q, k, v)

    # strided (B, N, H, Dh) views, ragged sizes, column-coded V
    B, H, Dh = 2, 3, 64
    code = ((torch.arange(Dh, device="cuda") * 37) % Dh) / (Dh / 2) - 1.0
    worst_ragged = 0.0
    for Nq in ATTN_RAGGED:
        for Nk in ATTN_RAGGED:
            q = randn(B, Nq, H, Dh).to(torch.bfloat16).transpose(1, 2)
            k = randn(B, Nk, H, Dh).to(torch.bfloat16).transpose(1, 2)
            v = (0.1 * randn(B, Nk, H, Dh) + code).to(torch.bfloat16) \
                .transpose(1, 2)
            worst_ragged = max(worst_ragged, held(
                f"strided B={B} H={H} Nq={Nq} Nk={Nk}", "bf16", q, k, v))
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv = randn(1, 768, 3, 16, Dh).to(dt)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        held("views of a packed qkv (1, 768, 3, 16, 64)", name, q, k, v)

    timings = {}
    for label, (B, H, Nq, Nk, Dh) in (("encoder", ATTN_SHAPES[0]),
                                      ("decoder", ATTN_SHAPES[1])):
        q, k, v = (randn(B, H, n, Dh).to(torch.bfloat16)
                   for n in (Nq, Nk, Nk))
        qkv = randn(B, Nq, 3, H, Dh).to(torch.bfloat16)
        qs, ks, vs = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        flops = 4.0 * B * H * Nq * Nk * Dh
        nbytes = 2.0 * (2 * B * H * Nq * Dh + 2 * B * H * Nk * Dh)
        bound = max(flops / peak_flops, nbytes / peak_bw) * 1e3
        t = {
            "ms": time_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: attention_plain(q, k, v)),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound,
            "bound_by": "operations" if flops / peak_flops >= nbytes / peak_bw
            else "bytes",
            "max_abs_err": worst[(B, H, Nq, Nk, "bf16")],
            "max_abs_err_ragged_strided": worst_ragged,
            "ms_model_views": time_ms(lambda: flash_attention(qs, ks, vs)),
            "library_ms_model_views": time_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs)),
        }
        timings[label] = t
        print(f"attention bf16 {label} (1,{H},{Nq},{Dh}): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); on the model's strided views kernel "
              f"{t['ms_model_views']:.4f} ms, SDPA "
              f"{t['library_ms_model_views']:.4f} ms [{card}]")
    return timings


def check_gn(peak_bw, card):
    """Kernel B against its plain version at a pose far from the identity
    (``testing.gn_problem``), each of the 27 sums at its own scale
    (``testing.gn_sums_check``), and bitwise between two launches."""
    import torch

    from mast3r_slam_torch import testing
    from mast3r_slam_torch.ops import gn

    out = {}
    for n in (196608, 1000):
        pre, T = testing.gn_problem(n, seed=n, device="cuda")
        scal = gn.rot_scalars(T)
        a1 = gn.gn_sums(pre.pts, scal, 1.345)
        a2 = gn.gn_sums(pre.pts, scal, 1.345)
        terms = gn.gn_terms_plain(pre.pts, scal, 1.345)
        torch.cuda.synchronize()
        det = torch.equal(a1, a2)
        err, tol = testing.gn_sums_check(a1, terms)
        worst = int(torch.argmax(err / tol))
        ok = det and bool((err <= tol).all())
        print(f"gn n={n} pose {[round(x, 4) for x in T.tolist()]}: per-entry "
              f"err/tol max {float(err[worst] / tol[worst]):.3e} at sum "
              f"{worst} (err {float(err[worst]):.3e}, tol "
              f"{float(tol[worst]):.3e}; rtol {testing.GN_RTOL:.0e} + floor "
              f"{testing.GN_FLOOR:.0e} x sum|terms|); bitwise deterministic "
              f"{det}; {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("GN kernel disagrees with its plain version or "
                             "is not deterministic")
        if n == 196608:
            nbytes = 9 * 4.0 * n + 4.0 * gn.N_ACC
            out = {
                "ms": time_ms(lambda: gn.gn_sums(pre.pts, scal, 1.345),
                              reps=200),
                "plain_ms": time_ms(
                    lambda: gn.gn_sums_plain(pre.pts, scal, 1.345)),
                "library_ms": None,
                "bound_ms": nbytes / peak_bw * 1e3,
                "bound_by": "bytes",
                "max_abs_err": float(err.max()),
            }
            print(f"gn n={n}: kernel {out['ms']:.4f} ms (two launches), "
                  f"plain {out['plain_ms']:.4f} ms, bound "
                  f"{out['bound_ms']:.5f} ms (bytes) [{card}]")
    return out


def check_gn_solve(tcfg, peak_bw, card):
    """The whole-solve kernel against its plain version (the host loop over
    the plain sums, run on the same tensors on the card): from a pose near
    the solution (``testing.gn_problem``), from the identity (several
    iterations) and on a singular problem (all weights zero: ``ok`` False,
    T unchanged, one iteration).  Pose within ``GN_POSE_ATOL``, ``ok`` and
    the iteration count equal, two launches bitwise equal."""
    import torch

    from mast3r_slam_torch import testing
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops import lie_sim3 as sim3

    def held(what, pre, T0, expect_ok=True):
        T1, ok1, it1 = gn.gn_solve(pre, T0, tcfg)
        T2, ok2, it2 = gn.gn_solve(pre, T0, tcfg)
        Tp, okp, itp = gn.gn_solve_plain(pre, T0, tcfg)
        torch.cuda.synchronize()
        err = (T1 - Tp).abs().max().item()
        det = torch.equal(T1, T2) and ok1 == ok2 and it1 == it2
        good = det and err <= GN_POSE_ATOL and ok1 == okp == expect_ok \
            and it1 == itp
        if not expect_ok:
            good = good and torch.equal(T1, T0) and it1 == 1
        print(f"gn_solve {what}: {it1} iterations (plain {itp}), ok {ok1} "
              f"(plain {okp}), pose max abs err {err:.3e} (atol "
              f"{GN_POSE_ATOL:.0e}), bitwise deterministic {det}; "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            print(f"  kernel {T1.tolist()}\n  plain  {Tp.tolist()}")
            raise SystemExit("gn_solve disagrees with its plain version or "
                             "is not deterministic")
        return err, it1

    out = {}
    for n in (196608, 1000):
        pre, T = testing.gn_problem(n, seed=n, device="cuda")
        eye = sim3.identity(device="cuda")
        err_near, _ = held(f"n={n} from a pose near the solution", pre, T)
        err_far, iters = held(f"n={n} from the identity", pre, eye)
        zeros = torch.zeros(n, device="cuda")
        singular = gn.GNPointData(pre.pts[:3].T, pre.pts[3:7], zeros, zeros)
        held(f"n={n} singular (all weights zero)", singular, T,
             expect_ok=False)
        if n == 196608:
            out = {
                "ms": time_ms(lambda: gn.gn_solve_launch(pre.pts, eye, tcfg),
                              reps=50),
                "solve_ms": time_ms(lambda: gn.gn_solve(pre, eye, tcfg),
                                    reps=20),
                "plain_ms": time_ms(
                    lambda: gn.gn_solve_plain(pre, eye, tcfg), reps=3,
                    warmup=1),
                "library_ms": None,
                "bound_ms": 9 * 4.0 * n / peak_bw * 1e3,
                "bound_by": "bytes",
                "max_abs_err": max(err_near, err_far),
                "iterations": iters,
            }
            print(f"gn_solve n={n} from the identity, {iters} iterations: "
                  f"kernel {out['ms']:.4f} ms (one launch), with its one "
                  f"copy back {out['solve_ms']:.4f} ms, plain loop "
                  f"{out['plain_ms']:.4f} ms, "
                  f"bound {out['bound_ms']:.5f} ms (bytes: the points read "
                  f"once) [{card}]")
    return out


def pack_tables(cfg, hw_shape):
    """The packed tables one ``match`` builds at the matching block ``cfg``:
    (label, table dtype name, F, offsets, row0, n_rows) per ``pack_rows``
    launch, in launch order: the LM corner table, then one per dilation of
    the refine walk (``ops.matching.match_after_lm``)."""
    from mast3r_slam_torch.ops.pack import _offsets

    h, w = hw_shape
    hw = h * w
    lmt = cfg.lm_table_subsample == 2
    wt, hwt = (w // 2, hw // 4) if lmt else (w, hw)
    tables = [("lm corners", "f16", 9, (0, 1, wt, wt + 1), 0, hwt)]
    dt, fdim = ("int8", 24) if cfg.desc_bits == 8 else ("bf16", 24)

    def refine(radius, dilations, u_pack):
        k_side = 2 * radius + 1
        P = max(1, min(u_pack, k_side))
        for d in dilations:
            rd = radius * d
            nib = cfg.coarse_bits == 4 and dt == "int8" and d > 1 \
                and max(dilations) > 1
            tables.append((f"refine d={d} r={radius} u_pack={P}", dt,
                           fdim // 2 if nib else fdim,
                           tuple(_offsets(k_side, d, rd, w, P)), -rd,
                           hw + 2 * rd))

    def small_pack(r):
        return (2 * r + 1) if r <= 2 else 2

    if cfg.radius <= 0:
        return tables
    if cfg.coarse_subsample != 2:
        refine(cfg.radius, range(cfg.dilation_max, 0, -1), 2)
        return tables
    if cfg.dilation_max > 1:
        sched = cfg.dilation_schedule or tuple(range(cfg.dilation_max, 1, -1))
        refine(cfg.radius, sched[:1], 2)
        r_c = cfg.coarse_radius or cfg.radius
        refine(r_c, sched[1:], small_pack(r_c))
    if cfg.final_radius >= 0:
        r_f = cfg.final_radius or cfg.radius
        refine(r_f, (1,), small_pack(r_f))
    return tables


def desc_global_tables(cfg, hw_shape):
    """The packed tables one direction of ``match_desc_global`` builds
    (``ops.matching.match_desc_global``): the refine walk at radius 2,
    dilation 2 then 1, five probe columns a row, int8 q8 descriptors."""
    from mast3r_slam_torch.ops.pack import _offsets

    h, w = hw_shape
    if cfg.coarse_bits != 8:
        raise SystemExit("desc_global_tables: nibble tables are not the "
                         "production path")
    return [(f"desc_global refine d={d} r=2 u_pack=5", "int8", 24,
             tuple(_offsets(5, d, 2 * d, w, 5)), -2 * d, h * w + 4 * d)
            for d in (2, 1)]


def check_pack(match_cfg, peak_bw, card):
    """Kernel C against ``pack_rows_plain``, bitwise (it is a copy): every
    table of the production matcher at 384x512 in int8, f16, bf16 and f32,
    a batch of 2, a table no tile divides (300 x 7 rows), offsets beyond
    the table, K = 64 with 96-byte f32 rows, a ragged last tile, rows cut
    into groups of offsets, and source and output at odd byte offsets.
    Then the time of each production table in its own dtype beside its
    bound, the single advanced-index gather that computes the same table
    from a zero-padded copy, and the plain version."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops import pack

    dtypes = {"int8": torch.int8, "f16": torch.float16,
              "bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def table(dt, b, hw, f):
        return torch.randint(-127, 128, (b, hw, f), device="cuda",
                             generator=gen).to(dtypes[dt])

    def same(x, offs, row0, n_rows, what):
        got = pack.pack_rows(x, offs, row0, n_rows)
        ref = pack.pack_rows_plain(x, offs, row0, n_rows)
        torch.cuda.synchronize()
        ok = got.shape == ref.shape and got.dtype == ref.dtype and \
            torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
        print(f"pack {what}: {tuple(x.shape)} {x.dtype} -> "
              f"{tuple(got.shape)} bitwise equal {ok}")
        if not ok:
            raise SystemExit("pack kernel disagrees with its plain version")
        return got

    tables = pack_tables(match_cfg, IMG_HW)
    desc_tables = desc_global_tables(match_cfg, IMG_HW)
    for label, _, fdim, offs, row0, n_rows in tables + desc_tables:
        for dt in dtypes:
            same(table(dt, 1, n_rows + 2 * row0, fdim), offs, row0, n_rows,
                 f"{label} {dt}")
    hw_odd, w_odd = 300 * 7, 7
    offs_odd = tuple(pack._offsets(5, 2, 4, w_odd, 5))
    for dt in dtypes:
        same(table(dt, 2, hw_odd, 24), offs_odd, -4, hw_odd + 8,
             f"b=2 hw=300x7 {dt}")
    far = same(table("int8", 2, hw_odd, 24),
               (hw_odd + 4, -hw_odd - 4, 5 * hw_odd), -4, hw_odd + 8,
               "offsets beyond the table")
    if bool(far.any()):
        raise SystemExit("rows outside the table must read as zeros")
    # K = 64 offsets of 96-byte f32 rows; n_rows no tile divides; rows so
    # wide that the offsets are cut into groups
    same(table("f32", 2, 5000, 24), tuple(range(-300, 340, 10)), -5, 5003,
         "K=64, 96-byte f32 rows")
    same(table("f16", 3, 4099, 9), (0, 1, 97, 98), 2, 4099 + 113,
         "ragged last tile")
    same(table("f32", 1, 50, 5000), (0, 3, -2, 40), 0, 45,
         "20000-byte rows in groups of offsets")
    # source and output at odd byte offsets: contiguous slices of larger
    # buffers, `shift` bytes past a 16-byte boundary
    for dt, shift in (("int8", 1), ("int8", 7), ("f16", 2), ("f32", 4)):
        b, hw, fdim = 2, hw_odd, 9
        isz = torch.empty((), dtype=dtypes[dt]).element_size()
        n_in, n_out = b * hw * fdim, b * (hw + 8) * len(offs_odd) * fdim
        x = table(dt, 1, 1, n_in + 64)[0, 0, shift // isz:][:n_in]
        buf = torch.zeros(n_out + 64, dtype=dtypes[dt], device="cuda")
        out = buf[shift // isz:][:n_out].view(b, hw + 8, -1)
        x = x.view(b, hw, fdim)
        pack.pack_rows_into(out, x, offs_odd, -4)
        ref = pack.pack_rows_plain(x, offs_odd, -4, hw + 8)
        torch.cuda.synchronize()
        ok = x.data_ptr() % 16 == out.data_ptr() % 16 == shift and \
            torch.equal(out.view(torch.uint8), ref.view(torch.uint8)) and \
            not buf[:shift // isz].any() and \
            not buf[shift // isz + n_out:].any()
        print(f"pack source and output {shift} bytes past 16-byte alignment "
              f"{tuple(x.shape)} {x.dtype}: bitwise equal, nothing written "
              f"outside {ok}")
        if not ok:
            raise SystemExit("pack kernel disagrees with its plain version "
                             "at an odd alignment")

    def time_tables(tables, what):
        """Kernel, plain version and one advanced-index gather of each
        table, beside its bytes bound; their sums."""
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bound_ms": 0.0}
        per_table = []
        for label, dt, fdim, offs, row0, n_rows in tables:
            hw = n_rows + 2 * row0
            x = table(dt, 1, hw, fdim)
            lo = min(0, row0 + min(offs))
            hi = max(hw, row0 + n_rows + max(offs))
            padded = F.pad(x, (0, 0, -lo, hi - hw))
            index = (torch.arange(n_rows, device="cuda")[:, None]
                     + (row0 - lo)
                     + torch.tensor(offs, device="cuda")[None, :])
            lib = padded[:, index].reshape(1, n_rows, -1)
            if not torch.equal(lib, pack.pack_rows(x, offs, row0, n_rows)):
                raise SystemExit("the library gather computes another "
                                 "table")
            del lib
            nbytes = x.element_size() * fdim * (hw + n_rows * len(offs))
            t = {
                "ms": time_ms(
                    lambda: pack.pack_rows(x, offs, row0, n_rows), reps=100),
                "plain_ms": time_ms(
                    lambda: pack.pack_rows_plain(x, offs, row0, n_rows),
                    reps=20),
                "library_ms": time_ms(lambda: padded[:, index], reps=20),
                "bound_ms": nbytes / peak_bw * 1e3,
            }
            plan = pack.tile_plan(tuple(offs), fdim * x.element_size(),
                                  n_rows)
            print(f"pack {label} ({hw}, {fdim}) {dt} K={len(offs)} -> "
                  f"{n_rows} x {len(offs) * fdim * x.element_size()} B "
                  f"({plan.rows}-row tiles, {len(plan.span_lo)} spans, "
                  f"{plan.smem} B staged): kernel {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms (bytes), "
                  f"{100 * t['bound_ms'] / t['ms']:.1f}% of bound; gather "
                  f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
                  f"[{card}]")
            per_table.append(dict(label=label, **t))
            for key in total:
                total[key] += t[key]
        print(f"pack, the {len(tables)} tables of {what}: kernel "
              f"{total['ms']:.4f} ms, bound {total['bound_ms']:.5f} ms, "
              f"{100 * total['bound_ms'] / total['ms']:.1f}% of bound; "
              f"gather {total['library_ms']:.4f} ms, plain "
              f"{total['plain_ms']:.4f} ms [{card}]")
        return total, per_table

    total, per_table = time_tables(tables, "one match")
    desc_total, _ = time_tables(desc_tables, "one desc_global direction")
    total.update(bound_by="bytes", max_abs_err=0.0, tables=per_table,
                 desc_global_direction=desc_total,
                 host_us=pack_host_us(match_cfg, card))
    return total


def pack_host_us(match_cfg, card, reps=100):
    """Host time of one ``pack_rows`` call in microseconds (argument checks,
    the tiling, the output's allocation, the launch): the mean over
    ``reps`` rounds of the tables of one match, on the host's clock, with
    the card held busy by a spin kernel so that no call waits for it.  It
    takes only ``pack_rows``'s public signature, so it also times another
    tree's package:
    ``python3 -c "import runpy, sys; sys.path.insert(0, TREE);
    runpy.run_path('chip_smoke.py')['pack_host_report']()"``."""
    import torch

    from mast3r_slam_torch.ops.pack import pack_rows

    tables = pack_tables(match_cfg, IMG_HW)
    dtypes = {"int8": torch.int8, "f16": torch.float16,
              "bf16": torch.bfloat16}
    calls = [(torch.zeros(1, n_rows + 2 * row0, fdim, dtype=dtypes[dt],
                          device="cuda"), offs, row0, n_rows)
             for _, dt, fdim, offs, row0, n_rows in tables]
    for args in calls:
        pack_rows(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in calls:
            pack_rows(*args)
    us = (time.perf_counter() - t0) / (reps * len(calls)) * 1e6
    torch.cuda.synchronize()
    print(f"pack_rows host time: {us:.2f} us a call (mean of {reps} x "
          f"{len(calls)} calls, the card busy) [{card}]")
    return us


def pack_host_report():
    """``pack_host_us`` at ``config/base.yaml``'s matcher, for whichever
    ``mast3r_slam_torch`` is first on the path."""
    from mast3r_slam_torch import _build
    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.utils.config import load_config

    _build.build(["pack"])
    pack_host_us(MatchingConfig.from_dict(
        load_config("config/base.yaml")["matching"]), card_info())


def head_agreement(res, ref):
    """The acceptance figures of bf16 heads against a reference
    (``tests/test_model.py:161-195``) over one view's (X, C, D) on the
    card: 1 - cosine of pts3d and desc, mean relative depth error, mean
    relative confidence error."""
    import torch

    def one_minus_cos(a, b):
        a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-12)
        return 1.0 - cos.mean().item()

    X, C, D = (t.float() for t in res)
    X0, C0, D0 = (t.float() for t in ref)
    d, d0 = X.norm(dim=-1), X0.norm(dim=-1)
    out = {"pts3d_1_minus_cos": one_minus_cos(X, X0),
           "desc_1_minus_cos": one_minus_cos(D, D0),
           "rel_depth": ((d - d0).abs() / (d0.abs() + 1e-6)).mean().item(),
           "rel_conf": ((C - C0).abs().mean()
                        / (C0.abs().mean() + 1e-9)).item()}
    out["ok"] = bool(torch.isfinite(X).all() and torch.isfinite(D).all()
                     and out["pts3d_1_minus_cos"] < 1 - HEAD_COS_MIN
                     and out["desc_1_minus_cos"] < 1 - HEAD_COS_MIN
                     and out["rel_depth"] < HEAD_REL_DEPTH_MAX
                     and out["rel_conf"] < HEAD_REL_CONF_MAX)
    return out


def check_small_model():
    """The network through the kernels on the card against the same weights
    through the plain versions on the CPU, at a small size whose attention
    heads have Dh = 64: f32 heads to 1e-3 of each output's scale, then bf16
    heads (``main_torch.py``'s default) to the acceptance bounds of bf16
    heads (``head_agreement``), since cuDNN and the CPU round the bf16
    convolutions at other places."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    hw = (64, 96)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, hw[0], hw[1], 3)).astype(np.float32))
    names = ["feat", "X1", "C1", "D1", "Q1", "X2", "C2", "D2", "Q2"]
    for head_dtype in (torch.float32, torch.bfloat16):
        cfg = MASt3RConfig.tiny(enc_embed_dim=128, enc_num_heads=2,
                                dec_embed_dim=128, dec_num_heads=2,
                                head_dtype=head_dtype)
        torch.manual_seed(1)
        state = MASt3R(cfg).state_dict()
        res = {}
        for dev in ("cpu", "cuda"):
            model = MASt3R(cfg)
            model.load_state_dict(state)
            eng = InferenceEngine(model, hw, device=dev)
            feat, pos = eng.encode(img.to(dev))
            out1, out2 = eng.decode_pair(feat, pos, feat, pos)
            res[dev] = [t.float().cpu() for t in (feat, *out1, *out2)]
        tag = "f32" if head_dtype == torch.float32 else "bf16"
        for name, a, b in zip(names, res["cpu"], res["cuda"]):
            err = (a - b).abs().max().item()
            tol = 1e-3 * (1.0 + a.abs().max().item())
            print(f"small model, {tag} heads, {name}: card vs CPU max abs "
                  f"err {err:.3e}" + (f" (tol {tol:.1e})" if tag == "f32"
                                      or name == "feat" else ""))
            if (tag == "f32" or name == "feat") and not err <= tol:
                raise SystemExit("the network on the card disagrees with "
                                 "the CPU reference")
        if tag == "bf16":
            for view, sl in (("view 1", slice(1, 4)), ("view 2", slice(5, 8))):
                agree = head_agreement(res["cuda"][sl], res["cpu"][sl])
                print(f"small model, bf16 heads, {view}: card vs CPU "
                      f"{json.dumps(agree)} (bounds: 1 - cos < "
                      f"{1 - HEAD_COS_MIN:.0e}, rel depth < "
                      f"{HEAD_REL_DEPTH_MAX}, rel conf < {HEAD_REL_CONF_MAX})")
                if not agree["ok"]:
                    raise SystemExit("the bf16 heads on the card disagree "
                                     "with the CPU reference")


def check_heads(engine, sd, frames, card):
    """ViT-L bf16 heads (the production engine) against f32 heads of the
    same weights on the card (a second engine, ``--fp32-head``), on one
    frame pair of the clip, to the acceptance bounds of bf16 heads; then
    decode + heads timed for both head dtypes, and the device time of one
    traced decode of each."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    model32 = MASt3R(MASt3RConfig.vit_large(head_dtype=torch.float32))
    model32.load_state_dict(sd)
    eng32 = InferenceEngine(model32, IMG_HW, device="cuda")
    norm = [torch.from_numpy(f.astype(np.float32) * (1.0 / 127.5) - 1.0)
            [None].cuda() for f in frames[:2]]
    (f1, p1), (f2, p2) = (engine.encode(x) for x in norm)
    res16 = engine.decode_pair(f1, p1, f2, p2)
    res32 = eng32.decode_pair(f1, p1, f2, p2)
    out = {}
    for view, a, b in zip(("view 1", "view 2"), res16, res32):
        agree = head_agreement(a[:3], b[:3])
        print(f"ViT-L bf16 heads against f32 heads, {view}: "
              f"{json.dumps(agree)} (bounds: 1 - cos < "
              f"{1 - HEAD_COS_MIN:.0e}, rel depth < {HEAD_REL_DEPTH_MAX}, "
              f"rel conf < {HEAD_REL_CONF_MAX}) [{card}]")
        if not agree["ok"]:
            raise SystemExit("ViT-L bf16 heads outside the acceptance bounds")
        out[view] = agree
    for tag, eng in (("bf16", engine), ("f32", eng32)):
        out[f"decode_and_heads_{tag}_ms"] = time_ms(
            lambda: eng.decode_pair(f1, p1, f2, p2), reps=5, warmup=1)
        print(f"decode + heads, {tag} heads: "
              f"{out[f'decode_and_heads_{tag}_ms']:.3f} ms; one traced "
              f"decode:")
        busy, kernels = device_busy(lambda: eng.decode_pair(f1, p1, f2, p2),
                                    top=8)
        out[f"decode_and_heads_{tag}_device_busy_ms"] = busy
        out[f"decode_and_heads_{tag}_kernels"] = kernels
        print(f"  device busy {busy:.3f} ms, {kernels} kernels [{card}]")
    del eng32, model32
    torch.cuda.empty_cache()
    return out


def host_us(fn, reps=50):
    """Host time of one ``fn()`` in microseconds: the mean over ``reps``
    calls on the host's clock, the card held busy by a spin kernel so that
    no call waits for it (what a host-paced frame pays for the call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def timed_in_turns(label, fns, card):
    """Two versions of one call timed in turns (a, b, b, a): each turn's
    CUDA-event time (``time_ms``, mean of 5 after a warm-up) and host time
    (``host_us``, mean of 3); then one traced call of each, its device busy
    time and kernel count (``device_busy``).  ``fns`` maps each version's
    tag to the call."""
    (a, fa), (b, fb) = fns.items()
    out = {f"{label}_{t}_{k}": [] for t in fns for k in ("ms", "host_ms")}
    for tag, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[f"{label}_{tag}_ms"].append(time_ms(fn, reps=5, warmup=1))
        out[f"{label}_{tag}_host_ms"].append(host_us(fn, reps=3) / 1e3)
    for tag, fn in fns.items():
        print(f"{label}, {tag}: {_r(out[f'{label}_{tag}_ms'])} ms, host "
              f"time {_r(out[f'{label}_{tag}_host_ms'])} ms (in turns "
              f"{a}, {b}, {b}, {a}); one traced call:")
        busy, kernels = device_busy(fn, top=8)
        out[f"{label}_{tag}_device_busy_ms"] = busy
        out[f"{label}_{tag}_kernels"] = kernels
        print(f"  device busy {busy:.3f} ms, {kernels} kernels [{card}]")
    return out


def _cos_rel(ref, got):
    """(cosine, relative L2 error) of ``got`` against ``ref``, flattened,
    in f64: the acceptance figures of ``tests/test_quant.py``."""
    a, b = ref.double().flatten(), got.double().flatten()
    return ((a @ b / (a.norm() * b.norm())).item(),
            ((a - b).norm() / a.norm()).item())


def check_int8(engine, sd, mcfg, frames, peak_flops, peak_bw, card):
    """The int8 network path on the card, with the engine
    ``main_quantized_torch.py`` builds (``int8_encoder``) from the
    conditioned ViT-L weights, and a second engine on the same model with
    ``int8_local_head``:

    * every quantised weight, scale and bias on the card equals the CPU's
      quantisation of the same (bf16-cast) weights, bitwise;
    * at each of the six product shapes, the card's int32 accumulator
      equals the CPU's product bitwise (and the token codes the CPU's);
      ``torch._int_mm``, the whole ``_int8_matmul`` and the bf16 ``Dense``
      of the same shape timed (``time_ms``) beside their bounds (int8 at
      the data sheet's 1,979 TOP/s, bf16 at 989 TFLOP/s, 3.35 TB/s), and
      the host time of one call of each (``host_us``);
    * ViT-L encode, int8 against the production bf16 engine: ``pos``
      equal, cosine > 0.99 and relative error < 0.15
      (``tests/test_quant.py:29-32``); encode time, host time and device
      busy of both;
    * a small model's int8 encode on the card against the CPU.

    Returns (the int8 engine, the int8-local-head engine, figures)."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models import quant as tq
    from mast3r_slam_torch.models.mast3r import MASt3R, _product

    model = MASt3R(mcfg)
    model.load_state_dict(sd)
    eng_q = InferenceEngine(model, IMG_HW, device="cuda", int8_encoder=True)
    eng_l = InferenceEngine(eng_q.model, IMG_HW, device="cuda",
                            int8_local_head=True)
    out = {}

    # the quantised weights: card against the CPU on the same weights
    m = eng_q.model
    lins = [(f"enc_block_{i}", k, lin) for i, b in enumerate(m.enc_blocks)
            for k, lin in (("qkv", b.attn.qkv), ("proj", b.attn.proj),
                           ("fc1", b.mlp.fc1), ("fc2", b.mlp.fc2))]
    lins += [(f"local{n}", k, getattr(getattr(
        m, f"downstream_head{n}").head_local_features, k))
        for n in (1, 2) for k in ("fc1", "fc2")]
    trees = {**eng_q.qparams, **eng_l.qlocal}
    for name, k, lin in lins:
        cpu = tq._quantize_dense(lin.weight.cpu(), lin.bias.cpu())
        card_qd = trees[name][k]
        if card_qd.w_int8.device.type != "cuda" or not all(
                torch.equal(a.cpu(), b) for a, b in zip(card_qd, cpu)):
            raise SystemExit(f"int8 weights of {name}.{k} on the card differ "
                             f"from the CPU's")
    n_bytes = sum(t.numel() * t.element_size() for blk in trees.values()
                  for qd in blk.values() for t in qd)
    print(f"int8 weights: {len(lins)} Linears quantised on the card, equal "
          f"to the CPU's bitwise ({n_bytes / 1e6:.1f} MB: encoder "
          f"{len(eng_q.qparams)} blocks x 4, local heads 2 x 2; weights "
          f"{m.enc_blocks[0].attn.qkv.weight.dtype}) [{card}]")

    # the six products of the main path at 384x512 (768 tokens): an
    # encoder block's qkv, proj, fc1, fc2 and the local head's fc1, fc2
    i8_peak = _INT8_PEAKS[torch.cuda.get_device_name(0)]
    M = IMG_HW[0] * IMG_HW[1] // mcfg.patch_size ** 2
    gen = torch.Generator(device="cuda").manual_seed(8)
    products = []
    for block, k, lin in lins:
        if block not in ("enc_block_0", "local1"):
            continue
        name = f"{'encoder' if block == 'enc_block_0' else 'local head'} {k}"
        qd = trees[block][k]
        N, K = qd.w_int8.shape
        x = torch.randn(M, K, device="cuda", generator=gen)
        x8, _ = tq.quantize_tokens(x)
        x8_cpu, _ = tq.quantize_tokens(x.cpu())
        acc = tq.int_mm(x8, qd.w_int8.t())
        acc_cpu = torch._int_mm(x8_cpu, qd.w_int8.cpu().t())
        if not (torch.equal(x8.cpu(), x8_cpu)
                and torch.equal(acc.cpu(), acc_cpu)):
            raise SystemExit(f"int8 product {name} ({M} x {K}) . ({K} x "
                             f"{N}): the card's int32 accumulator differs "
                             f"from the CPU's")
        w_t = qd.w_int8.t()
        calls = {"int_mm": lambda: tq.int_mm(x8, w_t),
                 "int8_matmul": lambda: tq._int8_matmul(x, qd),
                 "dense_bf16": lambda: _product(
                     F.linear, x, lin.weight, lin.bias, torch.bfloat16)}
        ms = {k: time_ms(fn) for k, fn in calls.items()}
        us = {k: host_us(fn) for k, fn in calls.items()}
        ops = 2.0 * M * K * N
        bound = {
            "int_mm": max(ops / i8_peak, (M * K + K * N + 4 * M * N)
                          / peak_bw),
            "int8_matmul": max(ops / i8_peak, (4 * M * K + K * N + 8 * N
                                               + 4 * M * N) / peak_bw),
            "dense_bf16": max(ops / peak_flops, (4 * M * K + 2 * K * N
                                                 + 2 * N + 2 * M * N)
                              / peak_bw)}
        row = {"shape": [M, K, N], **{f"{k}_ms": v for k, v in ms.items()},
               **{f"{k}_bound_ms": 1e3 * v for k, v in bound.items()},
               **{f"{k}_host_us": v for k, v in us.items()}}
        products.append(dict(name=name, **row))
        print(f"int8 product {name} ({M} x {K}) . ({K} x {N}): int32 "
              f"accumulator and codes equal the CPU's; torch._int_mm "
              f"{ms['int_mm']:.4f} ms (bound {1e3 * bound['int_mm']:.4f}), "
              f"_int8_matmul {ms['int8_matmul']:.4f} ms (bound "
              f"{1e3 * bound['int8_matmul']:.4f}), bf16 Dense "
              f"{ms['dense_bf16']:.4f} ms (bound "
              f"{1e3 * bound['dense_bf16']:.4f}); host time a call "
              f"{us['int_mm']:.1f} / {us['int8_matmul']:.1f} / "
              f"{us['dense_bf16']:.1f} us [{card}]")
    out["int8_products"] = products

    # ViT-L encode: int8 against the production bf16 engine
    img = torch.from_numpy(frames[0].astype(np.float32) * (1.0 / 127.5)
                           - 1.0)[None].cuda()
    f16, p16 = engine.encode(img)
    f8, p8 = eng_q.encode(img)
    cos, rel = _cos_rel(f16, f8)
    ok = bool(torch.equal(p16, p8) and torch.isfinite(f8).all()
              and f8.dtype == torch.float32 and f8.shape == f16.shape)
    print(f"ViT-L encode, int8 against bf16: cosine {cos:.6f}, relative "
          f"error {rel:.5f} (acceptance: cosine > {INT8_COS_MIN}, relative "
          f"error < {INT8_REL_MAX}); pos equal, finite: {ok} [{card}]")
    if not ok or not (cos > INT8_COS_MIN and rel < INT8_REL_MAX):
        raise SystemExit("the ViT-L int8 encoder is outside its acceptance "
                         "bounds")
    out.update(encode_int8_cosine=cos, encode_int8_rel_err=rel)
    out.update(timed_in_turns("encode", {
        "bf16": lambda: engine.encode(img),
        "int8": lambda: eng_q.encode(img)}, card))
    out["small_model_int8_encode_err"] = check_small_model_int8()
    return eng_q, eng_l, out


def check_small_model_int8():
    """A small model's int8 encode (Dh = 64, 24 tokens) on the card against
    the same weights on the CPU, to ``INT8_SMALL_TOL`` of the features'
    scale: the card's attention kernel and the CPU's plain version round
    the bf16 attention differently, and a token whose int8 code flips
    moves by a quantisation step."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    hw = (64, 96)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, hw[0], hw[1], 3)).astype(np.float32))
    cfg = MASt3RConfig.tiny(enc_embed_dim=128, enc_num_heads=2,
                            dec_embed_dim=128, dec_num_heads=2)
    torch.manual_seed(1)
    state = MASt3R(cfg).state_dict()
    res = {}
    for dev in ("cpu", "cuda"):
        model = MASt3R(cfg)
        model.load_state_dict(state)
        eng = InferenceEngine(model, hw, device=dev, int8_encoder=True)
        feat, pos = eng.encode(img.to(dev))
        res[dev] = (feat.cpu(), pos.cpu())
    err = (res["cpu"][0] - res["cuda"][0]).abs().max().item()
    tol = INT8_SMALL_TOL * (1.0 + res["cpu"][0].abs().max().item())
    print(f"small model, int8 encoder: card vs CPU max abs err {err:.3e} "
          f"(tol {tol:.1e}), pos equal "
          f"{torch.equal(res['cpu'][1], res['cuda'][1])}")
    if not (err <= tol and torch.equal(res["cpu"][1], res["cuda"][1])):
        raise SystemExit("the int8 encoder on the card disagrees with the "
                         "CPU")
    return err


def check_int8_local_head(eng_q, eng_l, frames, card):
    """One decode of the same engine's model with the int8 local-feature
    MLPs against its bf16 heads: X and C equal within ``INT8_XC_ATOL`` of
    their scale (the DPT is the same code on the same tokens), descriptor
    cosine > 0.99 and Q relative error < 0.1
    (``tests/test_quant.py:83-87``); decode + heads time, host time and
    device busy of both."""
    import torch

    norm = [torch.from_numpy(f.astype(np.float32) * (1.0 / 127.5) - 1.0)
            [None].cuda() for f in frames[:2]]
    (f1, p1), (f2, p2) = (eng_q.encode(x) for x in norm)
    ref = eng_q.decode_pair(f1, p1, f2, p2)
    got = eng_l.decode_pair(f1, p1, f2, p2)
    out = {}
    for view, (X, C, D, Q), (Xq, Cq, Dq, Qq) in zip(("view 1", "view 2"),
                                                    ref, got):
        xc = max(((a - b).abs().max() / (1.0 + a.abs().max())).item()
                 for a, b in ((X, Xq), (C, Cq)))
        cos, _ = _cos_rel(D, Dq)
        _, rel = _cos_rel(Q, Qq)
        print(f"int8 local head against bf16 heads, {view}: X, C max err "
              f"{xc:.3e} of their scale (tol {INT8_XC_ATOL:.0e}), "
              f"descriptor cosine {cos:.6f} (> {INT8_DESC_COS_MIN}), Q "
              f"relative error {rel:.5f} (< {INT8_Q_REL_MAX}) [{card}]")
        if not (xc <= INT8_XC_ATOL and cos > INT8_DESC_COS_MIN
                and rel < INT8_Q_REL_MAX and torch.isfinite(Dq).all()):
            raise SystemExit("the int8 local head is outside its acceptance "
                             "bounds")
        out[view] = {"xc_err": xc, "desc_cosine": cos, "q_rel_err": rel}
    out.update(timed_in_turns("decode_and_heads", {
        "bf16_heads": lambda: eng_q.decode_pair(f1, p1, f2, p2),
        "int8_local_head": lambda: eng_l.decode_pair(f1, p1, f2, p2)}, card))
    return out


def compare_int8_drive(bf16, int8, card):
    """The int8 drive's frame times and keyframe poses beside the bf16
    production drive's (both threaded, one call)."""
    import torch

    for k in ("frame_ms", "keyframe_frame_ms", "tracked_frame_ms"):
        print(f"int8 drive against bf16: {k} int8 {_r(int8['timings'][k])}, "
              f"bf16 {_r(bf16['timings'][k])} [{card}]")
    print(f"int8 drive against bf16: drive_ms int8 "
          f"{int8['timings']['drive_ms']:.1f}, bf16 "
          f"{bf16['timings']['drive_ms']:.1f}; stats int8 "
          f"{int8['timings']['stats']}, bf16 {bf16['timings']['stats']}")
    out = {"last_pose_max_diff": (int8["last"] - bf16["last"]).abs().max()
           .item()}
    if int8["kf"].shape == bf16["kf"].shape:
        out["keyframe_pose_max_diff"] = (int8["kf"] - bf16["kf"]).abs().max() \
            .item()
    print(f"int8 drive against bf16: largest pose difference {out} "
          f"(keyframes {tuple(int8['kf'].shape)} / "
          f"{tuple(bf16['kf'].shape)}) [{card}]")
    if not all(torch.isfinite(t).all() for t in (int8["kf"], int8["last"])):
        raise SystemExit("the int8 drive's poses are not finite")
    return out


def network_breakdown_report(engine, stages, card):
    """``--profile-blocks`` on the ViT-L bf16 model at 384x512
    (``utils/breakdown.py``), printed as ``main_torch.py`` prints it, its
    "ViT total" (the sub-blocks times their counts) beside the measured
    encode and decode + heads stage times."""
    from mast3r_slam_torch.utils.breakdown import (network_breakdown,
                                                   print_network_summary)

    res = network_breakdown(engine.model, IMG_HW)
    vit_ms = 1e3 * sum(res.values())
    stage_ms = stages["encode"] + stages["decode_and_heads"]
    print_network_summary(res, extra={
        "measured encode stage (ms)": round(stages["encode"], 3),
        "measured decode + heads stage (ms)": round(
            stages["decode_and_heads"], 3)})
    print(f"breakdown: ViT total {vit_ms:.3f} ms (sub-blocks x counts, "
          f"heads not included) against the measured encode + decode + "
          f"heads stages {stage_ms:.3f} ms [{card}]")
    if not all(v > 0 for v in res.values()):
        raise SystemExit("the network breakdown has a section without time")
    return {"breakdown_ms": {k: 1e3 * v for k, v in res.items()},
            "breakdown_vit_total_ms": vit_ms,
            "breakdown_encode_plus_decode_stages_ms": stage_ms}


def build_engine(seed):
    """The ViT-L network with the weights of ``torch.manual_seed(seed)``,
    conditioned so that the clip tracks
    (``testing.condition_for_tracking``), with bf16 heads as
    ``main_torch.py`` builds it by default, in an engine on the card.
    Returns the engine, the configuration and the f32 state dict."""
    import torch

    from mast3r_slam_torch.models.mast3r import MASt3RConfig
    from mast3r_slam_torch.testing import build_seeded_engine

    mcfg = MASt3RConfig.vit_large(head_dtype=torch.bfloat16)
    engine, sd = build_seeded_engine(mcfg, IMG_HW, seed, device="cuda")
    return engine, mcfg, sd


def drive_frontend(engine, mcfg, cfg, frames, card, label, state_out=None,
                   backend_device=None, viewer=None):
    """``main_torch.run`` (dataset -> ``SLAMSystem.process_frame`` -> the
    backend's rounds -> summary) over an in-memory clip with the
    configuration ``cfg`` (``config/base.yaml``: the rounds on the backend
    thread), then the trajectory written with ``evaluate.save_traj`` and
    read back.  Every kernel's count is set to 0 just before the loop and
    read just after; the counts must be what the drive's frames and its
    edges (pose-warped or through the symmetric decode, as the spies on the
    engine count them) imply.  The drive must make two keyframes, a backend
    round and an edge.  Each frame's ``process_frame`` and each backend
    round are timed on the host clock, as the frame loop sees them (no
    synchronise added: a frame ends with host reads of its results), and
    the last round's BA inputs are kept for ``check_ba``.  With
    ``state_out`` the run saves its state there (``--state-out``), timed.
    ``backend_device`` goes to the system (``--backend-device``); an
    engine split over a mesh launches kernel A once per entry.  With a
    ``viewer`` (a ``viz_server.LiveViewer``) the loop publishes to it at
    ``main.py``'s cadence; each publish is timed on the host clock with the
    keyframe rows and bytes it copied, and so is each frame's PNG.  Besides
    each frame, the loop's iterations are timed start to start (the
    publishes between frames included), and the frames that follow a
    keyframe (INIT's included) are kept apart (``ROADMAP.md`` B.8)."""
    import torch

    import main_torch
    from mast3r_slam_torch import evaluate
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.ops.pack import pack_rows
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import ClipDataset
    from mast3r_slam_torch.tracker import TrackerConfig

    engine.match_cfg = MatchingConfig.from_dict(cfg["matching"])
    system = SLAMSystem(cfg, engine, IMG_HW, device="cuda",
                        backend_device=backend_device)
    if (system._bdev is None) != (backend_device is None):
        raise SystemExit(f"{label}: backend_device={backend_device} was not "
                         f"taken")
    mesh = getattr(engine, "mesh", None)
    n_split = mesh.shape["model"] if mesh is not None else 1
    threaded = system._backend_thread is not None
    timing = {"frames": [], "rounds": [], "starts": [], "publishes": [],
              "pngs": []}
    record = {}
    sym_pairs, warped = [], []

    def timed(out):
        def hook(fn, *a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            out.append(((time.perf_counter() - t0) * 1e3, res))
            return res
        return hook

    def timed_frame(fn, *a):
        timing["starts"].append(time.perf_counter())
        return timed(timing["frames"])(fn, *a)

    def timed_publish(fn, *a, **kw):
        rows, nbytes = viewer.rows_pulled, viewer.bytes_pulled
        t0 = time.perf_counter()
        fn(*a, **kw)
        timing["publishes"].append(((time.perf_counter() - t0) * 1e3,
                                    viewer.rows_pulled - rows,
                                    viewer.bytes_pulled - nbytes))

    def keep_inputs(fn, arena, residual):
        g = system.graph
        n = arena.n_size
        record.update(
            residual=residual, n_edges=g.n_edges, ii=g.ii.copy(),
            jj=g.jj.copy(), n_size=n, K=g.K,
            arena={k: getattr(arena, k)[:n].clone() for k in
                   ("X", "C", "N", "N_updates", "T_WC")},
            store={k: t[:g.n_edges].clone()
                   for k, t in zip(STORE, g._stores())})
        res = fn(arena, residual)
        record["result"] = res
        return res

    def keep_args(fn, *a, **kw):
        record["add_factors"] = (a, kw)
        return fn(*a, **kw)

    def save_timed(fn, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(path)
        timing["state_save_s"] = time.perf_counter() - t0

    spies = [_Spy(system, "process_frame", timed_frame),
             _Spy(system, "_process_task", timed(timing["rounds"])),
             _Spy(system.graph, "solve_poses", keep_inputs),
             _Spy(system.graph, "add_factors", keep_args),
             _Spy(system, "save_state", save_timed),
             # the backend's decodes and matches go through its engine
             # (this one, or its copy on the backend card)
             _Spy(system.graph._eng, "match_symmetric",
                  _counting(sym_pairs, True)),
             _Spy(system.graph._eng, "match_arrays_warp",
                  _counting(warped, False))]
    if viewer is not None:
        spies += [_Spy(viewer, "publish", timed_publish),
                  _Spy(viewer, "publish_frame", timed(timing["pngs"]))]
    dataset = ClipDataset(frames)
    args = main_torch.parse_args(
        ["--no-viz"] + (["--state-out", state_out] if state_out else []))
    try:
        torch.cuda.synchronize()
        flash_attention.launches = pack_rows.launches = 0
        gn.gn_sums.launches = gn.gn_solve.launches = 0
        t0 = time.perf_counter()
        summary = main_torch.run(system, dataset, args, viewer=viewer)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"attention": flash_attention.launches,
                    "gn_accumulate": gn.gn_sums.launches,
                    "gn_solve": gn.gn_solve.launches,
                    "pack_rows": pack_rows.launches}
    finally:
        for spy in reversed(spies):
            spy.restore()
    if threaded and system._backend_thread.is_alive():
        raise SystemExit(f"{label}: the backend thread outlived terminate")

    # the drive: the frame loop and the final drain, not the state save
    wall_ms -= 1e3 * timing.get("state_save_s", 0.0)
    stats = summary["stats"]
    n = summary["frames"]
    n_edges = system.graph.n_edges
    print(f"{label}: {n} frames in {wall_ms:.1f} ms, stats {stats}, mean GN "
          f"iterations {summary['mean_gn_iters']:.2f}, {n_edges} edges, "
          f"{system.ba_iters_total} BA iterations in "
          f"{summary['ba_rounds']} rounds, backend "
          f"{'on a thread' if threaded else 'inline'} [{card}]")
    if summary["lost_at"] is not None or n != len(frames) or \
            stats["skipped"]:
        raise SystemExit(f"{label}: the drive lost tracking (random "
                         f"weights)")
    tracked = stats["tracked"]
    if tracked != n - 1:
        raise SystemExit(f"{label}: {tracked} tracked frames of {n - 1}")
    if stats["keyframes"] < 2 or stats["ba_rounds"] < 1 or n_edges < 1:
        raise SystemExit(f"{label}: the drive made {stats['keyframes']} "
                         f"keyframes, {stats['ba_rounds']} BA rounds and "
                         f"{n_edges} edges: the backend was not exercised")

    # every frame encodes once and decodes once (INIT: mono decode;
    # TRACKING: asymmetric decode), each decode with 4 attentions a block;
    # a symmetric edge decodes both directions in one B=2 decode and a
    # batch of them is matched in one batched match, a pose-warped edge only
    # matches (on the edge subgrid, with as many tables as a full match).
    # Each round adds its consecutive edge one way or the other: warped
    # when the tracker's match of the pair is still the one the frontend
    # left (on a thread, the frontend may have made the next keyframe
    # first), symmetric otherwise.
    n_sym = sum(sym_pairs)
    if len(warped) + n_sym != n_edges:
        raise SystemExit(f"{label}: {len(warped)} warped and {n_sym} "
                         f"symmetric edge matches for {n_edges} edges")
    expect_attn = ((mcfg.enc_depth + 4 * mcfg.dec_depth) * n
                   + 4 * mcfg.dec_depth * n_sym) * n_split
    per_match = len(pack_tables(engine.match_cfg, IMG_HW))
    expect_pack = per_match * (tracked + len(warped) + len(sym_pairs))
    joint = TrackerConfig.from_config(cfg).joint_ray_huber
    print(f"{label}: attention launches {launches['attention']} (expected "
          f"{expect_attn} = (({mcfg.enc_depth} + {4 * mcfg.dec_depth}) x {n} "
          f"frames + {4 * mcfg.dec_depth} x {n_sym} symmetric edges) x "
          f"{n_split} entries); "
          f"pack launches {launches['pack_rows']} (expected {expect_pack} = "
          f"{per_match} tables x ({tracked} tracked frames + {len(warped)} "
          f"pose-warped edges + {len(sym_pairs)} symmetric batches)); "
          f"gn_solve launches {launches['gn_solve']} "
          f"({'one per tracked frame' if joint else 'none: per-component Huber'}"
          f", {system.tracker.gn_iters_total} GN iterations in all); "
          f"gn_accumulate launches {launches['gn_accumulate']}")
    if launches["attention"] != expect_attn:
        raise SystemExit("attention launches do not match the drive")
    if launches["pack_rows"] != expect_pack:
        raise SystemExit("pack launches do not match the drive")
    expect_gn = tracked if joint else 0
    if launches["gn_solve"] != expect_gn or launches["gn_accumulate"] or \
            system.tracker.gn_iters_total < tracked:
        raise SystemExit(f"gn_solve launches {launches['gn_solve']} do not "
                         f"match the drive ({expect_gn} solves)")
    launches["gn_iterations"] = system.tracker.gn_iters_total

    n_kf = system.arena.n_size
    tensors = {
        "keyframe pointmaps": system.arena.X[:n_kf],
        "keyframe confidences": system.arena.C[:n_kf],
        "keyframe poses": system.arena.T_WC[:n_kf],
        "last pose": system.last_T_WC,
        "edge weights": system.graph.Q_ii2jj[:n_edges],
    }
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"non-finite {name}")
    if tuple(system.arena.X.shape[1:]) != (IMG_HW[0] * IMG_HW[1], 3):
        raise SystemExit("unexpected pointmap shape")
    if system.graph.idx_ii2jj.device.type != "cuda" or \
            system.arena.T_WC.device.type != "cuda":
        raise SystemExit("the edge store or the arena is not on the card")
    with tempfile.TemporaryDirectory() as tmp:
        evaluate.save_traj(tmp, "traj.txt", dataset.timestamps, system.arena)
        ts, pos, quat = evaluate.load_tum_trajectory(f"{tmp}/traj.txt")
    if len(ts) != n_kf or not np.allclose(
            pos, system.arena.T_WC[:n_kf, :3].cpu().numpy(), rtol=1e-5,
            atol=1e-6) or not np.allclose(np.linalg.norm(quat, axis=-1), 1.0,
                                          atol=1e-5):
        raise SystemExit(f"{label}: the trajectory file does not hold the "
                         f"keyframe poses")
    g = system.graph

    def mb(ts):
        return sum(t.numel() * t.element_size() for t in ts) / 1e6

    store_mb, cache_mb = mb(g._stores()), mb(g._pres())
    print(f"{label}: {n_kf} keyframes, all outputs finite, trajectory "
          f"written and read back; edge store {store_mb:.1f} MB for "
          f"{g.max_edges} edges (int32 indices, bool masks, f32 weights), "
          f"pregather cache {cache_mb:.1f} MB")

    # frame times: a frame that made a keyframe (inline, with its backend
    # round) against a plain tracked frame; the first frame (INIT) is left
    # out
    frame_ms = [ms for ms, _ in timing["frames"]]
    kf_ms = [ms for (ms, info) in timing["frames"][1:] if info["new_kf"]]
    plain_ms = [ms for (ms, info) in timing["frames"][1:]
                if not info["new_kf"]]
    # a frame after one that made a keyframe (INIT's first one included)
    after_kf_ms = [ms for (ms, _), (_, prev) in zip(timing["frames"][1:],
                                                     timing["frames"])
                   if prev["new_kf"] or prev["mode"] == "INIT"]
    iteration_ms = [float(x) for x in 1e3 * np.diff(timing["starts"])]
    rounds_ms = [ms for ms, _ in timing["rounds"]]
    print(f"{label}: process_frame ms {_r(frame_ms)}, keyframe frames "
          f"{_r(kf_ms)}, frames after a keyframe {_r(after_kf_ms)}, plain "
          f"tracked frames {_r(plain_ms)}; loop iterations start to start "
          f"{_r(iteration_ms)}; backend rounds (add_factors + solve_poses, "
          f"{'on the thread' if threaded else 'inline'}) {_r(rounds_ms)}; "
          f"the drive {wall_ms:.1f} ms (host clock) [{card}]")
    timings = {"frame_ms": frame_ms, "keyframe_frame_ms": kf_ms,
               "after_keyframe_frame_ms": after_kf_ms,
               "iteration_ms": iteration_ms,
               "tracked_frame_ms": plain_ms,
               "backend_round_ms": rounds_ms[1:],   # round 0: INIT, no edge
               "drive_ms": wall_ms, "stats": stats,
               "ba_iterations": system.ba_iters_total,
               "ba_rounds": stats["ba_rounds"], "edges": n_edges,
               "warped_edges": len(warped), "symmetric_edges": n_sym,
               "edge_store_mb": store_mb, "pregather_cache_mb": cache_mb}
    if "state_save_s" in timing:
        timings["state_save_s"] = timing["state_save_s"]
    if viewer is not None:
        timings.update(
            publish_ms=[ms for ms, _, _ in timing["publishes"]],
            publish_rows=[r for _, r, _ in timing["publishes"]],
            publish_bytes=[b for _, _, b in timing["publishes"]],
            frame_png_ms=[ms for ms, _ in timing["pngs"]])
        print(f"{label}: {len(timing['publishes'])} map publishes, ms "
              f"{_r(timings['publish_ms'])}, keyframe rows pulled "
              f"{timings['publish_rows']}, bytes copied to the host "
              f"{timings['publish_bytes']}; {len(timing['pngs'])} frame "
              f"PNGs, ms {_r(timings['frame_png_ms'])} [{card}]")
    if system._bdev is not None:
        timings["mirror_rows_copied"] = system.mirror_rows_copied
        if system.graph.idx_ii2jj.device != system._bdev or \
                system._marena.X.device != system._bdev:
            raise SystemExit(f"{label}: the edge store or the mirror is not "
                             f"on the backend device")
    return launches, system, record, timings


def _graph_from_record(record, cfg, dev, **graph_kw):
    """A backend round's inputs kept by ``drive_frontend`` (the arena's
    rows and the edge store) copied to ``dev``: (arena, ``FactorGraph``
    with ``cfg`` and ``graph_kw``)."""
    from mast3r_slam_torch import global_opt
    from mast3r_slam_torch.frame import make_arena

    A = record["arena"]
    arena = make_arena(A["X"].shape[0], *IMG_HW, 1, 1, dev)
    for k, t in A.items():
        getattr(arena, k).copy_(t.to(dev))
    arena.n_size = record["n_size"]
    if "mesh" not in graph_kw:
        graph_kw["store_device"] = dev
    g = global_opt.FactorGraph(type("Engine", (), {"device": dev})(),
                               IMG_HW[0] * IMG_HW[1], cfg, K=record["K"],
                               **graph_kw)
    n = record["n_edges"]
    if n > g.max_edges:
        g._grow(n)
    for k, t in record["store"].items():
        getattr(g, k)[:n] = t.to(g.dev)
    g.ii[:n], g.jj[:n], g.n_edges = record["ii"][:n], record["jj"][:n], n
    return arena, g


def _round_system(arena, g, residual, pose_floor=1):
    """The inputs of a GN solve of ``g``'s edges on ``arena`` as
    ``FactorGraph.solve_poses`` prepares them: (Twc, Xs, Cs, ii2, jj2,
    idx2, vm2, Q2, edge_valid), the edges two-way in a bucket of 4, the
    poses padded to a multiple of ``pose_floor`` with keyframe 0 (inert: it
    has no edge)."""
    import torch

    from mast3r_slam_torch import global_opt

    dev = g.dev
    n = g.n_edges
    unique = g.get_unique_kf_idx()
    remap = {int(k): c for c, k in enumerate(unique)}
    E_b = global_opt._next_bucket(n, 4)
    ii2 = np.zeros(2 * E_b, np.int64)
    jj2 = np.zeros(2 * E_b, np.int64)
    ev = np.zeros(2 * E_b, bool)
    for e in range(n):
        a, b = remap[int(g.ii[e])], remap[int(g.jj[e])]
        ii2[e], jj2[e], ii2[E_b + e], jj2[E_b + e] = a, b, b, a
        ev[e] = ev[E_b + e] = True
    ii2, jj2, ev = (torch.from_numpy(x).to(dev) for x in (ii2, jj2, ev))
    uidx = np.zeros(-(-len(unique) // pose_floor) * pose_floor, np.int64)
    uidx[:len(unique)] = unique
    T0, Xs, Cs, idx2, vm2, Q2 = global_opt._prep_system(
        arena.X, arena.C, arena.N, arena.T_WC, *g._stores(),
        torch.from_numpy(uidx).to(dev), g._K(), E_b, (arena.img_hw[1],
                                                      arena.img_hw[0]),
        residual == "calib")
    return T0, Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev


def check_ba(record, cfg, card):
    """The last backend round's BA inputs (arena, edge store) copied to the
    CPU and solved there by the same port code, held against the card's
    solve of that round: H and g of one GN iteration within ``BA_HG_RTOL``
    of their largest entry, the same iteration count and ok, the poses
    within ``BA_POSE_ATOL``; the card solving the copied inputs again
    gives the drive's result within the same limit."""
    from mast3r_slam_torch.ops import ba

    residual = record["residual"]
    img_wh = IMG_HW[::-1]
    results = {}
    for dev in ("cuda", "cpu"):
        arena, g = _graph_from_record(record, cfg, dev)
        upd, Twc, stats = g.solve_poses(arena, residual)
        # one GN iteration's H and g at the round's starting poses
        T0, Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev = _round_system(
            arena, g, residual)
        pre = ba._pregather_edges(Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev, g.cfg,
                                  min(g.cfg.chunk_points, idx2.shape[1]),
                                  img_wh)
        Hs, gs = ba._accumulate_pre(residual, T0, ii2, jj2, pre, g._K(),
                                    img_wh, g.cfg)
        results[dev] = (upd, Twc.cpu(), stats, Hs.cpu(), gs.cpu())
    (upd_c, T_c, st_c, H_c, g_c), (upd_h, T_h, st_h, H_h, g_h) = \
        results["cuda"], results["cpu"]
    _, T_drive, st_drive = record["result"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    h_err, g_err = rel(H_c, H_h), rel(g_c, g_h)
    pose_err = float((T_c - T_h).abs().max())
    drive_err = float((T_drive.cpu() - T_c).abs().max())
    print(f"BA check (last round, {record['n_edges']} edges, "
          f"{len(g.get_unique_kf_idx())} keyframes): card against CPU, one "
          f"iteration's H "
          f"{h_err:.3g} and g {g_err:.3g} relative (limit {BA_HG_RTOL}); "
          f"iterations {st_c[0]} / {st_h[0]} (the drive {st_drive[0]}), "
          f"last |dx| {st_c[1]:.4g} / {st_h[1]:.4g}, ok {st_c[2]} / "
          f"{st_h[2]}; poses {pose_err:.3g} apart (limit {BA_POSE_ATOL}); "
          f"the drive's solve against the card's again {drive_err:.3g} "
          f"[{card}]")
    if not (h_err <= BA_HG_RTOL and g_err <= BA_HG_RTOL
            and st_c[0] == st_h[0] == st_drive[0] and st_c[2] == st_h[2]
            and pose_err <= BA_POSE_ATOL and drive_err <= BA_POSE_ATOL
            and np.array_equal(upd_c, upd_h)):
        raise SystemExit("the card's BA disagrees with the CPU's")
    return {"ba_check_H_rel": h_err, "ba_check_g_rel": g_err,
            "ba_check_pose_abs": pose_err, "ba_check_drive_abs": drive_err,
            "ba_check_last_dx": st_c[1]}


def backend_breakdown(system, record, card):
    """The last backend round of the production drive again, warm: its
    ``add_factors`` (the pose-warped edge, its weights and the store
    write) on a fresh factor graph with the round's arguments, then
    ``solve_poses`` (the cache refresh and the BA) on the drive's arena,
    timed on the host clock and traced (device busy, kernels); and the
    drive's own graph solved again, traced, for the kernels per BA
    iteration."""
    import torch

    from mast3r_slam_torch.global_opt import FactorGraph

    rtype = "calib" if system.use_calib else "ray"
    hw = IMG_HW[0] * IMG_HW[1]
    args, kw = record["add_factors"]

    def graph():
        return FactorGraph(system.engine, hw, system.cfg, K=system.K,
                           store_device="cuda")

    def backend_round(g):
        g.add_factors(*args, **kw)
        return g.solve_poses(system.arena, rtype)

    backend_round(graph())                 # warm-up
    g = graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = backend_round(g)[2][0]
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    g = graph()
    round_busy, round_kernels = device_busy(lambda: backend_round(g), top=6)
    del g
    sg = system.graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg.solve_poses(system.arena, rtype)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    busy, kernels = device_busy(lambda: sg.solve_poses(system.arena, rtype),
                                top=8)
    per_iter = kernels / max(iters, 1)
    print(f"backend round (warm): {round_ms:.3f} ms on the clock "
          f"(add_factors + solve_poses, {iters} BA iterations), device busy "
          f"{round_busy:.3f} ms, idle share {1.0 - round_busy / round_ms:.3f},"
          f" {round_kernels} kernels; its solve alone {solve_ms:.3f} ms, "
          f"device busy {busy:.3f} ms, {kernels} kernels, {per_iter:.1f} per "
          f"BA iteration [{card}]")
    torch.cuda.empty_cache()
    return {"backend_round_warm_ms": round_ms,
            "backend_round_device_busy_ms": round_busy,
            "backend_round_kernels": round_kernels,
            "backend_round_idle_share": 1.0 - round_busy / round_ms,
            "ba_solve_ms": solve_ms, "ba_solve_iterations": iters,
            "ba_solve_device_busy_ms": busy, "ba_solve_kernels": kernels,
            "ba_kernels_per_iteration": per_iter,
            "ba_solve_idle_share": 1.0 - busy / solve_ms}


def drive_oracle(card):
    """The oracle harness on the card: the 16-frame 48x64 clip of
    ``tests/test_pipeline.py`` rendered with known poses, ``OracleEngine``
    in place of the network, the whole system (backend inline)
    uncalibrated and calibrated, the trajectory scored by ATE against the
    ground truth and against the same drive on the CPU."""
    import torch

    from mast3r_slam_torch import evaluate
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import OracleEngine, SyntheticSequence
    from mast3r_slam_torch.utils.config import load_config

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    out = {}
    for mode, path in (("uncalibrated", "config/eval_no_calib.yaml"),
                       ("calibrated", "config/eval_calib.yaml")):
        ates, systems = {}, {}
        for dev in ("cuda", "cpu"):
            cfg = load_config(path)
            cfg["dataset"]["img_size"] = 64
            engine = OracleEngine(seq, device=dev)
            system = SLAMSystem(cfg, engine, (seq.h, seq.w),
                                K=seq.K if cfg["use_calib"] else None,
                                buffer=32, device=dev)
            gn.gn_solve.launches = 0
            for i in range(len(seq)):
                system.process_frame(i, seq.images[i])
            system.terminate()
            if dev == "cuda":
                torch.cuda.synchronize()
                solves = gn.gn_solve.launches
            with tempfile.TemporaryDirectory() as tmp:
                evaluate.save_traj(tmp, "est.txt", seq.timestamps,
                                   system.arena)
                seq.write_gt(f"{tmp}/gt.txt")
                ates[dev] = evaluate.ate_rmse(f"{tmp}/gt.txt",
                                              f"{tmp}/est.txt", max_diff=0.05)
            systems[dev] = system
        system = systems["cuda"]
        ate = ates["cuda"]
        print(f"oracle drive {mode}: ATE RMSE {ate:.6f} m (limit "
              f"{ORACLE_ATE_LIMIT[mode]} m; the CPU {ates['cpu']:.6f} m), "
              f"stats {system.stats}, {system.ba_iters_total} BA iterations, "
              f"gn_solve launches {solves} [{card}]")
        if system.stats["skipped"] or system.stats["keyframes"] < 2 or \
                system.stats["ba_rounds"] < 1 or \
                system.stats != systems["cpu"].stats or \
                not ate < ORACLE_ATE_LIMIT[mode] or \
                abs(ate - ates["cpu"]) > ORACLE_ATE_CPU_ATOL:
            raise SystemExit(f"oracle drive {mode} failed")
        out[mode] = ate
        out[f"{mode}_cpu"] = ates["cpu"]
        out[f"{mode}_ba_rounds"] = system.stats["ba_rounds"]
    return out


def check_state(system, engine, path, save_s, card):
    """The production drive's end state, saved by ``main_torch.run`` with
    ``--state-out`` (``save_state``: JAX's ``.npz`` of the whole arena at
    ``map.buffer`` slots and the edge store at ``max_edges`` rows), loaded
    into a fresh system on the card: every arena field, the edge store and
    the stats come back bitwise, the poses as ``load_state`` re-normalises
    them (the saved poses normalised on the card).  Prints the file's bytes
    and the save and load seconds (host clock, the card synchronised)."""
    import dataclasses
    import os

    import torch

    from mast3r_slam_torch.ops import lie_sim3 as sim3
    from mast3r_slam_torch.pipeline import SLAMSystem

    nbytes = os.path.getsize(path)
    fresh = SLAMSystem(system.cfg, engine, IMG_HW, device="cuda")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mode = fresh.mode.name
    finally:
        fresh.terminate()
    a, b = system.arena, fresh.arena
    differ = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "n_size":
            same = x == y
        else:
            if f.name == "T_WC":
                x = sim3.normalize(x)
            same = x.dtype == y.dtype and x.device == y.device and \
                torch.equal(x, y)
        if not same:
            differ.append(f"arena.{f.name}")
    g, h = system.graph, fresh.graph
    differ += [f"graph.{k}" for k, x, y in zip(STORE, g._stores(),
                                                h._stores())
               if x.dtype != y.dtype or not torch.equal(x, y)]
    if g.n_edges != h.n_edges or g.max_edges != h.max_edges or \
            not np.array_equal(g.ii, h.ii) or not np.array_equal(g.jj, h.jj):
        differ.append("graph.ii / jj / n_edges")
    if fresh.stats != system.stats or mode != "TRACKING":
        differ.append(f"stats {fresh.stats} or mode {mode}")
    shift = float((sim3.normalize(a.T_WC) - a.T_WC).abs().max())

    def mb(ts):
        return sum(t.numel() * t.element_size() for t in ts) / 1e6

    arena_mb = mb([getattr(a, f.name) for f in dataclasses.fields(a)
                   if f.name != "n_size"])
    store_mb = mb(g._stores())
    print(f"state: the production drive's end state ({a.n_size} of "
          f"{a.buffer} keyframe slots, {g.n_edges} of {g.max_edges} edges; "
          f"arena {arena_mb:.1f} MB, edge store {store_mb:.1f} MB on the "
          f"card) saved in {save_s:.2f} s to a {nbytes} byte file, loaded "
          f"into a fresh system in {load_s:.2f} s; every arena field and "
          f"edge-store array back bitwise: {not differ} (poses re-normalised "
          f"by load_state, which moved them by {shift:.3g}) [{card}]")
    if differ:
        raise SystemExit(f"state: {differ} did not come back as saved")
    del fresh
    torch.cuda.empty_cache()
    return {"state_file_bytes": nbytes, "state_save_s": save_s,
            "state_load_s": load_s, "state_arena_mb": arena_mb,
            "state_edge_store_mb": store_mb,
            "state_normalise_pose_shift": shift}


def compare_threaded_inline(runs, card, label,
                            modes=("threaded", "inline")):
    """A drive's frames with the backend on its thread
    (``config/base.yaml``) beside the same frames with ``single_thread:
    True`` (or two other ``modes``), on the host clock as the frame loop
    sees them: ``runs`` holds each mode's drives (run in turns); a key
    that one of the drives lacks is left out."""
    keys = [k for k in ("frame_ms", "keyframe_frame_ms",
                        "after_keyframe_frame_ms", "tracked_frame_ms",
                        "iteration_ms", "drive_ms", "stats")
            if all(k in t for mode in modes for t in runs[mode])]
    print(f"{label}, {modes[0]} against {modes[1]} [{card}]:")
    for k in keys:
        for mode in modes:
            vals = [t[k] for t in runs[mode]]
            vals = [_r(v) if isinstance(v, list) else
                    round(v, 1) if isinstance(v, float) else v for v in vals]
            print(f"  {k} {mode}: {'; '.join(map(str, vals))}")
    return {f"compare_{mode}_{k}": [t[k] for t in runs[mode]]
            for mode in modes for k in keys}


def _oracle_system(seq, path, single_thread, retrieval=False,
                   backend_device=None, **engine_kw):
    """``SLAMSystem`` on the card over an oracle clip at the config
    ``path``, ``single_thread`` as given, with the oracle database if
    ``retrieval``, the backend on ``backend_device``; ``engine_kw`` go to
    ``OracleEngine``."""
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import OracleEngine, make_oracle_retrieval
    from mast3r_slam_torch.utils.config import load_config

    cfg = load_config(path)
    cfg["dataset"]["img_size"] = max(seq.h, seq.w)
    cfg["single_thread"] = single_thread
    engine = OracleEngine(seq, device="cuda", **engine_kw)
    return SLAMSystem(cfg, engine, (seq.h, seq.w), buffer=32, device="cuda",
                      retrieval=make_oracle_retrieval(seq, engine)
                      if retrieval else None, backend_device=backend_device)


def _oracle_run(system, seq, lo=0, hi=None, drain_each=False):
    """Frames ``lo:hi`` of ``seq``; the modes.  A drain never waits past
    ``DRAIN_S``."""
    from mast3r_slam_torch.testing import drain_within

    modes = []
    for i in range(lo, len(seq) if hi is None else hi):
        modes.append(system.process_frame(i, seq.images[i])["mode"])
        if drain_each:
            drain_within(system, DRAIN_S)
    drain_within(system, DRAIN_S)
    return modes


def _finish(system, label):
    system.terminate()
    if system._backend_thread is not None and \
            system._backend_thread.is_alive():
        raise SystemExit(f"{label}: the backend thread outlived terminate")


def _oracle_ate(seq, arena):
    from mast3r_slam_torch import evaluate

    with tempfile.TemporaryDirectory() as tmp:
        evaluate.save_traj(tmp, "est.txt", seq.timestamps, arena)
        seq.write_gt(f"{tmp}/gt.txt")
        return evaluate.ate_rmse(f"{tmp}/gt.txt", f"{tmp}/est.txt",
                                 max_diff=0.05)


def drive_oracle_threaded(card):
    """The backend on its thread on the card: the 16-frame oracle clip at
    ``config/eval_no_calib.yaml`` with ``single_thread: False``, once with
    a bounded drain after every frame (it must equal the inline card run:
    stats, edges, BA iterations, poses within ``ORACLE_THREAD_ATOL``) and
    once free-running (no backend error, ATE under the JAX tests' 0.05 m);
    then the blackout clip with the oracle database, free-running: it must
    relocalize and end tracking."""
    from mast3r_slam_torch.testing import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    path = "config/eval_no_calib.yaml"
    runs = {}
    for name, single, each in (("inline", True, False),
                               ("drained", False, True),
                               ("free", False, False)):
        system = _oracle_system(seq, path, single)
        t0 = time.perf_counter()
        _oracle_run(system, seq, drain_each=each)
        _finish(system, f"oracle {name}")
        runs[name] = (system, (time.perf_counter() - t0) * 1e3,
                      _oracle_ate(seq, system.arena))
    (ref, ref_ms, ref_ate), (thr, thr_ms, thr_ate), (free, free_ms, free_ate) = \
        runs["inline"], runs["drained"], runs["free"]
    n = ref.arena.n_size
    same = thr.stats == ref.stats and thr.arena.n_size == n and \
        thr.ba_iters_total == ref.ba_iters_total and \
        np.array_equal(thr.graph.ii[:thr.graph.n_edges],
                       ref.graph.ii[:ref.graph.n_edges]) and \
        np.array_equal(thr.graph.jj[:thr.graph.n_edges],
                       ref.graph.jj[:ref.graph.n_edges])
    err = float((thr.arena.T_WC[:n] - ref.arena.T_WC[:n]).abs().max()) \
        if thr.arena.n_size == n else float("inf")
    print(f"oracle drive, backend on its thread with a drain after every "
          f"frame: stats {thr.stats}, the inline card run's stats, edges and "
          f"BA iterations {same}, keyframe poses {err:.3g} apart (limit "
          f"{ORACLE_THREAD_ATOL}), ATE {thr_ate:.6f} m (inline "
          f"{ref_ate:.6f}); {thr_ms:.1f} ms against {ref_ms:.1f} inline "
          f"[{card}]")
    print(f"oracle drive, backend on its thread, free-running: stats "
          f"{free.stats}, ATE {free_ate:.6f} m (limit "
          f"{ORACLE_ATE_LIMIT['uncalibrated']}), {free_ms:.1f} ms [{card}]")
    if not same or not err <= ORACLE_THREAD_ATOL:
        raise SystemExit("the threaded oracle drive with a drain per frame "
                         "differs from the inline one")
    if not free_ate < ORACLE_ATE_LIMIT["uncalibrated"] or \
            free.stats["ba_rounds"] < 1:
        raise SystemExit("the free-running threaded oracle drive failed")

    blk = SyntheticSequence(n_frames=14, h=32, w=48, seed=0, traj_scale=0.4)
    system = _oracle_system(blk, path, False, retrieval=True,
                            blackout_frames={6})
    modes = _oracle_run(system, blk)
    ended = system.mode.name
    _finish(system, "oracle blackout")
    print(f"oracle blackout clip, backend on its thread with the oracle "
          f"database: modes {modes}, ended {ended}, stats {system.stats}, "
          f"{system.reloc_attempts} relocalization attempts [{card}]")
    if "RELOC" not in modes or ended == "RELOC" or \
            system.reloc_attempts < 1 or system.stats["keyframes"] < 2:
        raise SystemExit("the threaded oracle drive did not relocalize")
    return {"threaded_drained_pose_abs": err, "threaded_drained_ate": thr_ate,
            "threaded_free_ate": free_ate, "threaded_drive_ms": thr_ms,
            "inline_drive_ms": ref_ms, "free_drive_ms": free_ms,
            "blackout_reloc_attempts": system.reloc_attempts,
            "blackout_stats": system.stats}


def drive_oracle_state(card):
    """Save / resume on the card: the 16-frame oracle clip at
    ``config/eval_no_calib.yaml``, saved after frame 8, loaded into a fresh
    system (the oracle's frame counter at 8) and finished; it must equal the
    uninterrupted card run's stats, edges and BA iterations, poses within
    ``ORACLE_RESUME_ATOL``."""
    from mast3r_slam_torch.testing import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    path, half = "config/eval_no_calib.yaml", 8
    full = _oracle_system(seq, path, True)
    _oracle_run(full, seq)
    _finish(full, "oracle uninterrupted")
    first = _oracle_system(seq, path, True)
    _oracle_run(first, seq, hi=half)
    second = _oracle_system(seq, path, True)
    second.engine._encode_counter = half
    with tempfile.TemporaryDirectory() as tmp:
        first.save_state(f"{tmp}/half.npz")
        second.load_state(f"{tmp}/half.npz")
    _oracle_run(second, seq, lo=half)
    _finish(second, "oracle resumed")
    n = full.arena.n_size
    same = second.stats == full.stats and second.arena.n_size == n and \
        second.ba_iters_total == full.ba_iters_total and \
        np.array_equal(second.graph.ii[:second.graph.n_edges],
                       full.graph.ii[:full.graph.n_edges])
    err = float((second.arena.T_WC[:n] - full.arena.T_WC[:n]).abs().max()) \
        if second.arena.n_size == n else float("inf")
    print(f"oracle save at frame {half} and resume on the card: stats "
          f"{second.stats}, the uninterrupted run's stats, edges and BA "
          f"iterations {same}, keyframe poses {err:.3g} apart (limit "
          f"{ORACLE_RESUME_ATOL}) [{card}]")
    if not same or not err <= ORACLE_RESUME_ATOL:
        raise SystemExit("the resumed oracle drive differs from the "
                         "uninterrupted one")
    return {"resume_pose_abs": err}


def breakdown(system, img, card, label, full=True):
    """Device time of each stage of one tracking step against the last
    keyframe, on the drive's own state: encode, decode + heads, dense match
    (quantisation included, as the engine runs it), the packed tables of
    that match alone, the GN pose solve (inputs captured from a
    ``track_step``), the whole ``track_step`` and, beside the one-launch
    solve, the loop it replaced on the same inputs (the sums' kernel and a
    copy back per iteration, the rest on the host).  Each figure is the mean
    of five back-to-back runs after one warm-up.  ``full=False`` times the
    matcher's stages and the step only."""
    import torch

    from mast3r_slam_torch import tracker as trk
    from mast3r_slam_torch.frame import arena_get
    from mast3r_slam_torch.ops import gn, matching
    from mast3r_slam_torch.ops.pack import pack_rows

    eng = system.engine
    mcfg = eng.match_cfg = matching.MatchingConfig.from_dict(
        system.cfg["matching"])
    kf = arena_get(system.arena, system.arena.n_size - 1)
    frame = system.create_frame(0, img)
    hw = IMG_HW[0] * IMG_HW[1]
    idx0 = torch.arange(hw, device="cuda")[None]
    normed = torch.from_numpy(system.prepare_image(img)[0])[None].cuda()
    args = (frame.feat[None], frame.pos[None], kf.feat[None], kf.pos[None])
    (X1, _, D1, _), (X2, _, D2, _) = eng.decode_pair(*args)

    def match():
        q1, q2 = matching._q8_pair(D1, D2.reshape(1, hw, -1),
                                   mcfg.desc_prenorm)
        return matching.match(X1, X2, q1, q2.reshape(D2.shape), idx0,
                              cfg=mcfg)

    # the tables of this match, from its own ray field and descriptors
    rays, _, _ = matching.prep_for_iter_proj(
        X1, X2, idx0, table_subsample=mcfg.lm_table_subsample)
    src = {"f16": rays.reshape(1, -1, 9).to(torch.float16).contiguous(),
           "int8": matching._q8_pair(D1, D1, mcfg.desc_prenorm)[0]
           .reshape(1, hw, -1).contiguous(),
           "bf16": D1.reshape(1, hw, -1).to(torch.bfloat16).contiguous()}
    tables = pack_tables(mcfg, IMG_HW)

    def pack():
        for _, dt, _, offs, row0, n_rows in tables:
            pack_rows(src[dt], offs, row0, n_rows)

    captured = {}
    solve = trk.opt_pose_ray_dist_sim3

    def spy(*a):
        captured["args"] = a
        return solve(*a)

    trk.opt_pose_ray_dist_sim3 = spy
    try:
        trk.track_step(eng, frame, kf, idx0, system.tracker.cfg)
    finally:
        trk.opt_pose_ray_dist_sim3 = solve
    iters = solve(*captured["args"])[2]
    Xf_m, Xk_m, T0, Qk_m, valid_m, tcfg = captured["args"]

    def per_iteration_loop():
        # the loop gn_solve replaced: the sums' kernel and a copy back per
        # iteration, the 7x7 solve and the retraction on the host
        pre = trk.ray_dist_point_data(Xf_m, Xk_m, Qk_m, valid_m, tcfg)
        return gn.gn_loop(
            lambda T: gn.gn_accumulate(pre, T, tcfg.huber_k), T0, tcfg)

    def step():
        return trk.track_step(eng, frame, kf, idx0, system.tracker.cfg)

    stages = {"match": match, "pack": pack,
              "gn_solve": lambda: solve(*captured["args"]),
              "track_step": step}
    if full:
        stages = {"encode": lambda: eng.encode(normed),
                  "decode_and_heads": lambda: eng.decode_pair(*args),
                  **stages}
        if tcfg.joint_ray_huber:
            stages["gn_per_iteration_loop"] = per_iteration_loop
    out = {name: time_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    for name, ms in out.items():
        note = {"gn_solve": f" ({iters} GN iterations)",
                "gn_per_iteration_loop": f" ({per_iteration_loop()[2]} GN "
                f"iterations, the loop before gn_solve)",
                "pack": f" ({len(tables)} tables)"}.get(name, "")
        print(f"{label} stage {name}: {ms:.3f} ms{note} [{card}]")
    out["gn_iters"] = iters
    if full:
        out["device_busy_ms"], out["device_kernels"] = device_busy(step)
        out["idle_share"] = 1.0 - out["device_busy_ms"] / out["track_step"]
        print(f"{label} track_step: device busy "
              f"{out['device_busy_ms']:.3f} ms of {out['track_step']:.3f} "
              f"ms, idle share {out['idle_share']:.3f}, "
              f"{out['device_kernels']} kernels [{card}]")
    return out


def forge_retrieval_files(tmp, seed, dim):
    """The retrieval database's two files, forged from ``seed``: a head in
    the published state-dict layout (``RetrievalParams.random``, ``dim`` ->
    ``dim``, ViT-L's 1024, weights stored (out, in)) and a codebook pickle
    of ``CODEBOOK_WORDS`` random ``dim``-d words in the published
    ``Codebook.state_dict()`` layout.  Returns the two paths."""
    import pickle

    import torch

    from mast3r_slam_torch.retrieval.model import RetrievalParams

    p = RetrievalParams.random(dim, (dim,), seed=seed)
    head = f"{tmp}/retrieval_trainingfree.pth"
    torch.save({"model": {
        "projector.0.weight": p.proj_weights[0][0].T.contiguous(),
        "projector.0.bias": p.proj_weights[0][1],
        "prewhiten.m": p.prewhiten_m, "prewhiten.p": p.prewhiten_p,
        "postwhiten.m": p.postwhiten_m, "postwhiten.p": p.postwhiten_p}},
        head)
    cent = np.random.default_rng(seed).standard_normal(
        (CODEBOOK_WORDS, dim), dtype=np.float32)
    codebook = f"{tmp}/codebook.pkl"
    with open(codebook, "wb") as f:
        pickle.dump({"type": "Codebook", "params": {"size": "64k"},
                     "state": {"centroids": cent}}, f, protocol=4)
    return head, codebook


class _Spy:
    """Replaces ``owner.name`` by a wrapper that calls ``hook(fn, *args)``
    with the original ``fn``, until ``restore``."""

    def __init__(self, owner, name, hook):
        self.owner, self.name = owner, name
        self.own = name in vars(owner)
        self.fn = getattr(owner, name)

        def call(*a, **kw):
            return hook(self.fn, *a, **kw)

        setattr(owner, name, call)

    def restore(self):
        if self.own:
            setattr(self.owner, self.name, self.fn)
        else:
            delattr(self.owner, self.name)


def _counting(out, batch):
    """A ``_Spy`` hook that appends each call's batch (the first argument's
    leading size) or 1 to ``out``."""
    def hook(fn, *a, **kw):
        out.append(a[0].shape[0] if batch else 1)
        return fn(*a, **kw)
    return hook


def cuda_timed(out):
    """A ``_Spy`` hook that appends each call's time between two CUDA
    events (ms) to ``out``."""
    import torch

    def hook(fn, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(*a, **kw)
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
        return res

    return hook


def drive_retrieval(engine, mcfg, cfg, frames, db, card,
                    label="retrieval drive"):
    """``main_torch.run`` over a loop clip (out and back, so the last
    keyframe sees the first frame's image again) with ``config/base.yaml``
    unmodified and the retrieval database ``db``: the backend's loop-closure
    proposals become ``desc_global`` edges, matched from the keyframes'
    stored q8 tables, and the pairs whose gates reject them go through the
    symmetric decode.  Every kernel's count is set to 0 just before the
    loop and read just after; they must be what the drive's frames, edges
    and desc_global pairs imply (4 packs per desc_global pair).  The drive
    must make 3 keyframes, a retrieval proposal and a desc_global batch,
    and every desc_global pair must be accepted or retried.  The rounds run
    on the backend thread, as ``config/base.yaml`` says (inline with
    ``single_thread: True``).  Prints per
    keyframe the time of ``prep_features`` + ``quantize`` (CUDA events) and
    of the host IVF query, and per desc_global pair that of
    ``match_desc_global`` and its coarse argmax (CUDA events; on the
    stream both threads share, so they also hold the frontend's kernels
    queued between the two events)."""
    import torch

    import main_torch
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops import matching as matching_ops
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.pack import pack_rows
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import ClipDataset

    engine.match_cfg = matching_ops.MatchingConfig.from_dict(cfg["matching"])
    system = SLAMSystem(cfg, engine, IMG_HW, retrieval=db, device="cuda")
    g = system.graph
    feat_ms, quant_ms, ivf_ms, mdg_ms, coarse_ms = [], [], [], [], []
    pairs, retried, sym_pairs, warped, frame_ms = [], [], [], [], []

    def ivf_timed(fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        ivf_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    def mdg(fn, D8_i, D8_j, *a, **kw):
        # a copy: the frontend thread adds tables meanwhile
        ptr = {t.data_ptr(): r for r, (t, _) in dict(g.desc_store).items()}
        pairs.append((ptr[D8_i.data_ptr()], ptr[D8_j.data_ptr()]))
        return cuda_timed(mdg_ms)(fn, D8_i, D8_j, *a, **kw)

    def sym(fn, arena, ii, jj, *a, **kw):
        retried.extend(zip(map(int, ii), map(int, jj)))
        return fn(arena, ii, jj, *a, **kw)

    def frame_timed(fn, *a, **kw):
        t0 = time.perf_counter()
        info = fn(*a, **kw)
        frame_ms.append(((time.perf_counter() - t0) * 1e3, info["new_kf"]))
        return info

    spies = [_Spy(db, "_features", cuda_timed(feat_ms)),
             _Spy(db.codebook, "quantize", cuda_timed(quant_ms)),
             _Spy(db.ivf, "search_packed", ivf_timed),
             _Spy(matching_ops, "match_desc_global", mdg),
             _Spy(matching_ops, "_coarse_global_argmax",
                  cuda_timed(coarse_ms)),
             _Spy(g, "_add_factors_sym", sym),
             _Spy(engine, "match_symmetric", _counting(sym_pairs, True)),
             _Spy(engine, "match_arrays_warp", _counting(warped, False)),
             _Spy(system, "process_frame", frame_timed)]
    dataset = ClipDataset(frames, name="loop")
    args = main_torch.parse_args(["--no-viz"])
    try:
        torch.cuda.synchronize()
        flash_attention.launches = pack_rows.launches = 0
        gn.gn_sums.launches = gn.gn_solve.launches = 0
        t0 = time.perf_counter()
        summary = main_torch.run(system, dataset, args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"attention": flash_attention.launches,
                    "gn_accumulate": gn.gn_sums.launches,
                    "gn_solve": gn.gn_solve.launches,
                    "pack_rows": pack_rows.launches}
    finally:
        for s in reversed(spies):
            s.restore()

    stats = summary["stats"]
    n, n_edges = summary["frames"], g.n_edges
    edges = set(zip(g.ii[:n_edges].tolist(), g.jj[:n_edges].tolist()))
    kf_frames = system.arena.frame_id[:system.arena.n_size].tolist()
    print(f"{label}: {n} frames in {wall_ms:.1f} ms, stats {stats}, "
          f"keyframes at frames {kf_frames}, "
          f"{n_edges} edges {sorted(edges)}, desc_global batches "
          f"{g.n_desc_batches}, pairs {pairs}, retried through the "
          f"symmetric decode {retried} [{card}]")
    if summary["lost_at"] is not None or stats["skipped"] or \
            stats["tracked"] != n - 1:
        raise SystemExit(f"{label}: the drive lost tracking")
    if stats["keyframes"] < 3 or stats["retrieval_proposals"] < 1 or \
            g.n_desc_batches < 1:
        raise SystemExit(f"{label}: {stats['keyframes']} keyframes, "
                         f"{stats['retrieval_proposals']} proposals, "
                         f"{g.n_desc_batches} desc_global batches: the "
                         f"retrieval path was not exercised")
    if system._backend_thread is not None and \
            system._backend_thread.is_alive():
        raise SystemExit(f"{label}: the backend thread outlived terminate")
    lost = [p for p in pairs if p not in edges and p not in retried]
    if lost or g.n_desc_fallbacks != len(retried):
        raise SystemExit(f"{label}: desc_global pairs {lost} were "
                         f"neither accepted nor retried")

    per_match = len(pack_tables(engine.match_cfg, IMG_HW))
    tracked = stats["tracked"]
    n_sym = sum(sym_pairs)
    expect = {
        "attention": (mcfg.enc_depth + 4 * mcfg.dec_depth) * n
        + 4 * mcfg.dec_depth * n_sym,
        "pack_rows": per_match * (tracked + len(warped) + len(sym_pairs))
        + 4 * len(pairs),
        "gn_solve": tracked, "gn_accumulate": 0}
    print(f"{label}: attention launches {launches['attention']} "
          f"(expected {expect['attention']} = ({mcfg.enc_depth} + "
          f"{4 * mcfg.dec_depth}) x {n} frames + {4 * mcfg.dec_depth} x "
          f"{n_sym} symmetric pairs); pack launches {launches['pack_rows']} "
          f"(expected {expect['pack_rows']} = {per_match} tables x "
          f"({tracked} tracked frames + {len(warped)} warped edges + "
          f"{len(sym_pairs)} symmetric batches) + 4 x {len(pairs)} "
          f"desc_global pairs); gn_solve launches {launches['gn_solve']}")
    if launches != expect:
        raise SystemExit(f"{label}: kernel launches do not match the "
                         "drive")
    launches["gn_iterations"] = system.tracker.gn_iters_total

    def mb(ts):
        return sum(t.numel() * t.element_size() for t in ts) / 1e6

    desc_mb = mb([t for v in g.desc_store.values() for t in v])
    per_kf = desc_mb / len(g.desc_store)
    buffer = int(cfg["map"]["buffer"])
    accepted = sum(1 for p in pairs if p in edges and p not in retried)
    print(f"{label}: desc_global pairs accepted {accepted}, retried "
          f"{len(retried)} (n_desc_fallbacks {g.n_desc_fallbacks}); "
          f"desc_store {desc_mb:.2f} MB for {len(g.desc_store)} keyframes "
          f"({per_kf:.3f} MB each: int8 tables + f32 confidences), "
          f"{per_kf * buffer:.1f} MB at map.buffer {buffer}, beside the edge "
          f"store's {mb(g._stores()):.1f} MB for {g.max_edges} edges")
    kf_ms = [ms for ms, kf in frame_ms[1:] if kf]
    plain_ms = [ms for ms, kf in frame_ms[1:] if not kf]
    print(f"{label}: process_frame ms (host clock, as the frame loop "
          f"sees them; the rounds "
          f"{'inline' if system.single_thread else 'on the backend thread'}"
          f") {_r([ms for ms, _ in frame_ms])}, keyframe frames "
          f"{_r(kf_ms)}, plain tracked frames {_r(plain_ms)} [{card}]")
    print(f"{label}: per keyframe prep_features {_r(feat_ms)} ms, "
          f"quantize {_r(quant_ms)} ms ({db.codebook.size} words, CUDA "
          f"events), host IVF query {_r(ivf_ms)} ms (host clock); per "
          f"desc_global pair match_desc_global {_r(mdg_ms)} ms, of which "
          f"coarse argmax {_r(coarse_ms)} ms (two per pair; CUDA events) "
          f"[{card}]")
    n_kf = system.arena.n_size
    if not (bool(torch.isfinite(system.arena.T_WC[:n_kf]).all())
            and bool(torch.isfinite(system.arena.X[:n_kf]).all())):
        raise SystemExit(f"{label}: non-finite keyframe poses or "
                         "pointmaps")
    out = {"frames": n, "keyframes": stats["keyframes"],
           "retrieval_proposals": stats["retrieval_proposals"],
           "retrieval_edges": stats["retrieval_edges"],
           "desc_global_batches": g.n_desc_batches,
           "desc_global_pairs": len(pairs), "desc_accepted": accepted,
           "desc_fallbacks": g.n_desc_fallbacks,
           "desc_store_mb_per_keyframe": per_kf,
           "desc_store_mb_at_buffer": per_kf * buffer,
           "prep_features_ms": feat_ms, "quantize_ms": quant_ms,
           "ivf_query_ms": ivf_ms, "match_desc_global_ms": mdg_ms,
           "coarse_argmax_ms": coarse_ms, "drive_ms": wall_ms,
           "keyframe_frame_ms": kf_ms, "tracked_frame_ms": plain_ms,
           "frame_ms": [ms for ms, _ in frame_ms], "stats": stats}
    return launches, system, pairs, out


def _r(xs):
    return [round(x, 4) for x in xs]


def check_desc_global(system, pair, card):
    """One proposed pair's stored q8 tables from the retrieval drive
    through ``match_desc_global`` on the card and on the CPU: all eight
    outputs bitwise equal.  Then its time and that of one direction's
    coarse argmax between CUDA events (calls queued behind a spin kernel;
    a call whose launches outlast it shows the host's pace), and the
    device busy time and kernel count of one traced call of each."""
    import torch

    from mast3r_slam_torch.ops import matching as matching_ops

    g = system.graph
    (D8_i, dc_i), (D8_j, dc_j) = g.desc_store[pair[0]], g.desc_store[pair[1]]
    h, w = IMG_HW
    cfg = g.match_cfg
    card_out = matching_ops.match_desc_global(D8_i, D8_j, dc_i, dc_j, h, w,
                                              cfg)
    cpu_out = matching_ops.match_desc_global(
        *(t.cpu() for t in (D8_i, D8_j, dc_i, dc_j)), h, w, cfg)
    same = [torch.equal(a.cpu(), b) for a, b in zip(card_out, cpu_out)]
    vm = torch.cat([card_out[2], card_out[3]]).float().mean().item()
    q4 = D8_j[:, ::4, ::4].reshape(1, -1, D8_j.shape[-1])
    # ties: every 8x8 block of the table repeated from its corner, so each
    # key of the stride-4 grid has an equal twin; the first must win
    tied = D8_i[:, ::8, ::8].repeat_interleave(8, 1).repeat_interleave(8, 2)
    tie_card = matching_ops._coarse_global_argmax(tied, q4, h, w, s_key=4)
    tie_cpu = matching_ops._coarse_global_argmax(tied.cpu(), q4.cpu(), h, w,
                                                 s_key=4)
    same += [torch.equal(a.cpu(), b) for a, b in zip(tie_card, tie_cpu)]
    mdg_ms = time_ms(lambda: matching_ops.match_desc_global(
        D8_i, D8_j, dc_i, dc_j, h, w, cfg), reps=10, warmup=2)
    coarse_ms = time_ms(lambda: matching_ops._coarse_global_argmax(
        D8_i, q4, h, w, s_key=4), reps=10, warmup=2)
    busy, kernels = device_busy(lambda: matching_ops.match_desc_global(
        D8_i, D8_j, dc_i, dc_j, h, w, cfg), top=8)
    cbusy, ckernels = device_busy(lambda: matching_ops._coarse_global_argmax(
        D8_i, q4, h, w, s_key=4), top=4)
    print(f"desc_global card against CPU (pair {pair}, {h}x{w}): the eight "
          f"outputs and, on a table of tied keys, the coarse argmax's "
          f"three bitwise equal {same}, share of queries passing the gates "
          f"{vm:.4f}; match_desc_global {mdg_ms:.3f} ms between events, "
          f"device busy {busy:.3f} ms in {kernels} kernels; one direction's "
          f"coarse argmax ({q4.shape[1]} queries x {q4.shape[1]} keys) "
          f"{coarse_ms:.3f} ms, busy {cbusy:.3f} ms in {ckernels} kernels "
          f"[{card}]")
    if not all(same):
        raise SystemExit("match_desc_global on the card disagrees with the "
                         "CPU")
    return {"match_desc_global_ms": mdg_ms, "coarse_argmax_ms": coarse_ms,
            "match_desc_global_device_busy_ms": busy,
            "match_desc_global_kernels": kernels,
            "coarse_argmax_device_busy_ms": cbusy,
            "coarse_argmax_kernels": ckernels, "gate_pass_share": vm}


def drive_oracle_loop(card):
    """The 24-frame loop clip of ``tests/test_retrieval.py:216`` (32x48,
    ``noise_std 0.01``, seed 7) with the oracle's q8 descriptors
    (``export_desc``) and ``make_oracle_retrieval``, at
    ``config/eval_no_calib.yaml``, on the card and on the CPU: the same
    stats, edges and desc_global counts, a loop-closure edge, a desc_global
    batch, and the card's ATE within ``ORACLE_ATE_CPU_ATOL`` of the
    CPU's."""
    from mast3r_slam_torch import evaluate
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import (OracleEngine, SyntheticSequence,
                                           make_oracle_retrieval)
    from mast3r_slam_torch.utils.config import load_config

    seq = SyntheticSequence(n_frames=24, h=32, w=48, seed=3,
                            traj_scale=0.35, loop=True)
    res = {}
    for dev in ("cuda", "cpu"):
        cfg = load_config("config/eval_no_calib.yaml")
        cfg["dataset"]["img_size"] = 48
        engine = OracleEngine(seq, noise_std=0.01, seed=7, export_desc=True,
                              device=dev)
        system = SLAMSystem(cfg, engine, (seq.h, seq.w), buffer=32,
                            retrieval=make_oracle_retrieval(seq, engine),
                            device=dev)
        for i in range(len(seq)):
            system.process_frame(i, seq.images[i])
        system.terminate()
        with tempfile.TemporaryDirectory() as tmp:
            evaluate.save_traj(tmp, "est.txt", seq.timestamps, system.arena)
            seq.write_gt(f"{tmp}/gt.txt")
            ate = evaluate.ate_rmse(f"{tmp}/gt.txt", f"{tmp}/est.txt",
                                    max_diff=0.05)
        g = system.graph
        res[dev] = (dict(system.stats),
                    (g.ii[:g.n_edges].tolist(), g.jj[:g.n_edges].tolist()),
                    g.n_desc_batches, g.n_desc_fallbacks, ate)
    (stats, (ii, jj), nb, nf, ate), cpu = res["cuda"], res["cpu"]
    span = max(abs(a - b) for a, b in zip(ii, jj))
    print(f"oracle loop drive with retrieval: ATE {ate:.6f} m (the CPU "
          f"{cpu[4]:.6f} m), stats {stats}, {len(ii)} edges, widest span "
          f"{span}, desc_global batches {nb}, fallbacks {nf} [{card}]")
    if stats != cpu[0] or (ii, jj) != cpu[1] or (nb, nf) != cpu[2:4] or \
            nb < 1 or span <= 1 or abs(ate - cpu[4]) > ORACLE_ATE_CPU_ATOL:
        raise SystemExit("oracle loop drive with retrieval failed")
    return {"ate": ate, "ate_cpu": cpu[4], "desc_global_batches": nb,
            "desc_fallbacks": nf, "retrieval_edges": stats["retrieval_edges"]}


def build_tp_engine(sd, mcfg, devices=None):
    """The production network (the same weights, bf16 heads) split over a
    (1, 2) mesh of ``devices`` (default: the one card twice): every
    attention's heads and every MLP's hidden columns halved between them
    (``InferenceEngine(mesh=)``, ``--tp 2``)."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R
    from mast3r_slam_torch.parallel.mesh import make_mesh

    model = MASt3R(mcfg)
    model.load_state_dict(sd)
    card0 = torch.device("cuda", 0)
    mesh = make_mesh(n_edge=1, n_model=2,
                     devices=devices or [card0, card0])
    return InferenceEngine(model, IMG_HW, device="cuda", mesh=mesh)


def check_tp(engine, eng_tp, mcfg, frames, peak_flops, peak_bw, card):
    """Tensor parallel on the card: the split engine against the unsplit one
    on the clip's first two frames, encode and decode + heads (feat, X, C,
    D, Q: cosine and relative error within ``TP_COS_MIN`` /
    ``TP_REL_MAX``); kernel A's launches per encode and per decode (one a
    block and entry); both engines' encode and decode + heads timed in
    turns; and kernel A at the split heads' shapes against its plain
    version, timed beside SDPA at the same shapes and the bound."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import attention_plain, \
        flash_attention

    norm = [torch.from_numpy(f.astype(np.float32) * (1.0 / 127.5) - 1.0)
            [None].cuda() for f in frames[:2]]
    outs, counts = {}, {}
    for tag, eng in (("unsplit", engine), ("tp", eng_tp)):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        (f1, p1), (f2, p2) = (eng.encode(x) for x in norm)
        torch.cuda.synchronize()
        per_encode = flash_attention.launches // 2
        flash_attention.launches = 0
        v1, v2 = eng.decode_pair(f1, p1, f2, p2)
        torch.cuda.synchronize()
        counts[tag] = (per_encode, flash_attention.launches)
        outs[tag] = {"feat": torch.cat([f1, f2]),
                     **{k: torch.cat([a.flatten(), b.flatten()])
                        for k, a, b in zip("XCDQ", v1, v2)}}
    n_model = eng_tp.mesh.shape["model"]
    devs = eng_tp.mesh.axis_devices("model")
    where = "on one card" if len(set(devs)) == 1 else \
        "over " + ", ".join(map(str, devs))
    want = (mcfg.enc_depth * n_model, 4 * mcfg.dec_depth * n_model)
    print(f"tensor parallel (1, {n_model}) {where}: kernel A launches "
          f"per encode / decode {counts['tp'][0]} / {counts['tp'][1]} "
          f"(unsplit {counts['unsplit'][0]} / {counts['unsplit'][1]}; "
          f"expected {want[0]} / {want[1]})")
    if counts["tp"] != want:
        raise SystemExit("the tensor-parallel engine did not run kernel A on "
                         "each entry's heads")
    res = {"tp_attention_launches_per_encode": counts["tp"][0],
           "tp_attention_launches_per_decode": counts["tp"][1]}
    ok = True
    for k, ref in outs["unsplit"].items():
        got = outs["tp"][k]
        cos, rel = _cos_rel(ref, got)
        finite = bool(torch.isfinite(got).all())
        ok &= finite and cos >= TP_COS_MIN and rel <= TP_REL_MAX
        res[f"tp_{k}_cos"], res[f"tp_{k}_rel"] = cos, rel
        print(f"  {k}: cosine {cos:.7f}, relative error {rel:.3e} (bounds "
              f"{TP_COS_MIN}, {TP_REL_MAX}), finite {finite} [{card}]")
    if not ok:
        raise SystemExit("the tensor-parallel engine disagrees with the "
                         "unsplit one")
    f1, p1 = engine.encode(norm[0])
    f2, p2 = engine.encode(norm[1])
    res.update(timed_in_turns("encode", {
        "unsplit": lambda: engine.encode(norm[0]),
        "tp": lambda: eng_tp.encode(norm[0])}, card))
    res.update(timed_in_turns("decode_and_heads", {
        "unsplit": lambda: engine.decode_pair(f1, p1, f2, p2),
        "tp": lambda: eng_tp.decode_pair(f1, p1, f2, p2)}, card))

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = {}
    for label, (B, H, Nq, Nk, Dh) in TP_ATTN_SHAPES.items():
        q, k, v = (torch.randn(B, H, n, Dh, device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (Nq, Nk, Nk))
        err = (flash_attention(q, k, v).float()
               - attention_plain(q, k, v).float()).abs().max().item()
        if not err <= ATTN_TOL["bf16"]:
            raise SystemExit(f"kernel A at the split {label} shape "
                             f"disagrees with its plain version ({err})")
        flops = 4.0 * B * H * Nq * Nk * Dh
        nbytes = 2.0 * (2 * B * H * Nq * Dh + 2 * B * H * Nk * Dh)
        t = {"ms": time_ms(lambda: flash_attention(q, k, v)),
             "plain_ms": time_ms(lambda: attention_plain(q, k, v)),
             "library_ms": time_ms(
                 lambda: F.scaled_dot_product_attention(q, k, v)),
             "bound_ms": max(flops / peak_flops, nbytes / peak_bw) * 1e3,
             "bound_by": "operations" if flops / peak_flops
             >= nbytes / peak_bw else "bytes",
             "max_abs_err": err}
        shapes[label] = t
        print(f"attention bf16 split {label} ({B},{H},{Nq},{Dh}): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}), max abs err {err:.3e} [{card}]")
    res["attention_tp_shapes"] = shapes
    return res


def _graph_copy(g, cfg, **graph_kw):
    """A new ``FactorGraph`` holding ``g``'s edges, built with ``graph_kw``
    (a mesh) and ``cfg``."""
    from mast3r_slam_torch.global_opt import FactorGraph

    h = FactorGraph(g.engine, g.hw, cfg, K=g.K, **graph_kw)
    n = g.n_edges
    if n > h.max_edges:
        h._grow(n)
    for dst, src in zip(h._stores(), g._stores()):
        dst[:n] = src[:n].to(dst.device)
    h.ii[:n], h.jj[:n], h.n_edges = g.ii[:n], g.jj[:n], n
    return h


def _timed_solve(g, arena, rtype):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upd, T, stats = g.solve_poses(arena, rtype)
    torch.cuda.synchronize()
    return upd, T, stats, (time.perf_counter() - t0) * 1e3


def check_sharded_ba(record, cfg, card, devices=None):
    """The BA sharded over a 2-entry mesh of the one card
    (``FactorGraph(mesh=)``, ``local_opt.sharded_ba``), edge and map mode,
    against the single-device solve of the same graph: the 16-frame oracle
    drive's graph (converged) with equal iterations and poses within
    ``SHARD_POSE_ATOL``; the production drive's last round (unconverged,
    chaotic: ``ROADMAP.md`` C): its first iteration's reduced (H, g)
    within ``SHARD_HG_RTOL`` of the single-device system, one iteration's
    and the full solve's poses printed.  Each
    solve timed on the host clock after a warm-up (the sharded solves
    without the pregather cache, one (H, g) reduction an iteration).  The
    mesh's entries are ``devices`` (default: the one card twice)."""
    import torch

    from mast3r_slam_torch.ops import ba
    from mast3r_slam_torch.parallel.mesh import make_mesh
    from mast3r_slam_torch.parallel.sharded_ba import \
        sharded_normal_equations
    from mast3r_slam_torch.testing import SyntheticSequence

    card0 = torch.device("cuda", 0)
    devices = devices or [card0, card0]
    mesh = make_mesh(n_edge=len(devices), devices=devices)
    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    system = _oracle_system(seq, "config/eval_no_calib.yaml", True)
    _oracle_run(system, seq)
    _finish(system, "oracle drive for the sharded BA")
    out, ok = {}, True
    graphs = {"single": system.graph}
    for mode in ("edge", "map"):
        graphs[mode] = _graph_copy(system.graph, system.cfg, mesh=mesh,
                                   shard_mode=mode)
    solved = {}
    for tag, g in graphs.items():
        _timed_solve(g, system.arena, "ray")            # warm-up
        solved[tag] = _timed_solve(g, system.arena, "ray")
    upd0, T0, st0, ms0 = solved["single"]
    for mode in ("edge", "map"):
        # map mode pads the poses to a multiple of the edge axis: the rows
        # past the single-device solve's are padding, written nowhere
        upd, T, st, ms = solved[mode]
        err = float((T[:len(T0)].to(T0.device) - T0).abs().max())
        same = np.array_equal(upd[:len(upd0)], upd0) and bool(
            (upd[len(upd0):] >= system.arena.buffer).all()) and \
            st[0] == st0[0] and st[2]
        ok &= same and err <= SHARD_POSE_ATOL
        out[f"oracle_{mode}_pose_abs"], out[f"oracle_{mode}_ms"] = err, ms
        print(f"sharded BA ({mode}, {len(devices)} entries) on the oracle "
              f"graph ({system.graph.n_edges} edges): {st[0]} iterations "
              f"(single-device {st0[0]}), poses {err:.3g} apart (limit "
              f"{SHARD_POSE_ATOL}); {ms:.2f} ms against {ms0:.2f} ms "
              f"single-device [{card}]")
    out["oracle_single_ms"] = ms0

    # the production drive's last round: the reduced (H, g) of its first
    # iteration against the single-device one (the round's solve is too
    # ill-conditioned for its poses to show the reduction), then one
    # iteration's and the full solve's poses, printed
    rtype = record["residual"]
    arena, g0 = _graph_from_record(record, cfg, "cuda")
    T0, Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev = _round_system(
        arena, g0, rtype, pose_floor=len(devices))
    img_wh = IMG_HW[::-1]
    pre = ba._pregather_edges(Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev, g0.cfg,
                              min(g0.cfg.chunk_points, idx2.shape[1]),
                              img_wh)
    H0, gv0 = ba._assemble_dense(
        *ba._accumulate_pre(rtype, T0, ii2, jj2, pre, g0._K(), img_wh,
                            g0.cfg), ii2, jj2, T0.shape[0], g0.cfg.pin)
    for mode in ("edge", "map"):
        H, gv = sharded_normal_equations(
            mesh, T0, Xs, Cs, ii2, jj2, idx2, vm2, Q2, ev, g0._K(), rtype,
            img_wh, g0.cfg, shard_mode=mode)
        h_err = float((H - H0).abs().max() / H0.abs().max())
        g_err = float((gv - gv0).abs().max() / gv0.abs().max())
        ok &= h_err <= SHARD_HG_RTOL and g_err <= SHARD_HG_RTOL
        out[f"production_{mode}_H_rel"] = h_err
        out[f"production_{mode}_g_rel"] = g_err
        print(f"sharded BA ({mode}) on the production drive's last round "
              f"({record['n_edges']} edges): the first iteration's reduced H "
              f"{h_err:.3g} and g {g_err:.3g} from the single-device ones, "
              f"relative (limit {SHARD_HG_RTOL}) [{card}]")
    one = copy.deepcopy(cfg)
    one["local_opt"]["max_iters"] = 1
    for c, tag in ((one, "one_iteration"), (cfg, "full")):
        arena, g0 = _graph_from_record(record, c, "cuda")
        res = {"single": _timed_solve(g0, arena, rtype)}
        for mode in ("edge", "map"):
            _, g = _graph_from_record(record, c, "cuda", mesh=mesh,
                                      shard_mode=mode)
            res[mode] = _timed_solve(g, arena, rtype)
        _, T1, st1, ms1 = res["single"]
        for mode in ("edge", "map"):
            _, T, st, ms = res[mode]
            err = float((T[:len(T1)] - T1).abs().max())
            ok &= st[0] == st1[0] or tag == "full"
            out[f"production_{tag}_{mode}_pose_abs"] = err
            out[f"production_{tag}_{mode}_ms"] = ms
            print(f"sharded BA ({mode}) on the production drive's last round, "
                  f"{tag.replace('_', ' ')}: {st[0]} iterations "
                  f"(single-device {st1[0]}), poses {err:.3g} apart (printed, "
                  f"not held); {ms:.2f} ms against {ms1:.2f} ms [{card}]")
        out[f"production_{tag}_single_ms"] = ms1
    if not ok:
        raise SystemExit("the sharded BA disagrees with the single-device "
                         "solve")
    return out


def drive_oracle_backend_device(card, backend_device=0):
    """The backend on device 0 (``backend_device=0``: the mirror arena on
    the one card beside the live arena): the 16-frame oracle clip inline
    against the same drive without it, stats, edges and BA iterations
    equal and poses within ``BDEV_POSE_ATOL``, the rows copied to the
    mirror counted per round."""
    from mast3r_slam_torch.testing import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    path = "config/eval_no_calib.yaml"
    runs = {}
    for tag, bdev in (("single", None), ("backend_device", backend_device)):
        system = _oracle_system(seq, path, True, backend_device=bdev)
        t0 = time.perf_counter()
        _oracle_run(system, seq)
        _finish(system, f"oracle {tag}")
        runs[tag] = (system, (time.perf_counter() - t0) * 1e3)
    (ref, ref_ms), (bd, bd_ms) = runs["single"], runs["backend_device"]
    n = ref.arena.n_size
    same = bd.stats == ref.stats and bd.ba_iters_total == ref.ba_iters_total \
        and bd.arena.n_size == n and np.array_equal(
            bd.graph.ii[:bd.graph.n_edges], ref.graph.ii[:ref.graph.n_edges])
    err = float((bd.arena.T_WC[:n] - ref.arena.T_WC[:n]).abs().max()) \
        if bd.arena.n_size == n else float("inf")
    rounds = bd.stats["keyframes"]
    print(f"oracle drive with backend_device={backend_device}: stats "
          f"{bd.stats}, the "
          f"drive's without it {same}, keyframe poses {err:.3g} apart (limit "
          f"{BDEV_POSE_ATOL}); {bd.mirror_rows_copied} rows copied to the "
          f"mirror in {rounds} rounds; {bd_ms:.1f} ms against {ref_ms:.1f} "
          f"[{card}]")
    if not same or not err <= BDEV_POSE_ATOL or \
            bd._marena.X.device.type != "cuda":
        raise SystemExit("the oracle drive with a backend device differs")
    return {"oracle_pose_abs": err, "oracle_mirror_rows": bd.mirror_rows_copied,
            "oracle_rounds": rounds, "oracle_ms": bd_ms,
            "oracle_single_ms": ref_ms}


def check_kernels_off_current(cards, card):
    """Each kernel launched with its tensors on one card and another card
    current, both ways between the first two ``cards``: the wrappers make
    the tensors' card current, kernel A opts in to its shared memory there
    and ``gn_solve`` sizes its grid for it; every output against its plain
    version as in the kernel phase."""
    import torch

    from mast3r_slam_torch import testing
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import attention_plain, \
        flash_attention
    from mast3r_slam_torch.ops.pack import pack_rows, pack_rows_plain
    from mast3r_slam_torch.tracker import TrackerConfig

    rng = np.random.default_rng(0)
    offs = (0, 1, 64, 65)
    out = {}
    for home, other in ((cards[0], cards[1]), (cards[1], cards[0])):
        qkv = [torch.from_numpy(rng.standard_normal((1, 12, 768, 64))
                                .astype(np.float32)).to(home, torch.bfloat16)
               for _ in range(3)]
        pre, T = testing.gn_problem(196608, 196608, home)
        scal = gn.rot_scalars(T)
        flat = torch.from_numpy(rng.integers(-127, 128, (1, 4096, 24))).to(
            home, torch.int8)
        with torch.cuda.device(other):
            att = flash_attention(*qkv)
            sums = gn.gn_sums(pre.pts, scal, 1.345)
            T1, ok1, it1 = gn.gn_solve(pre, T, TrackerConfig())
            packed = pack_rows(flat, offs, 0, 4096)
        torch.cuda.synchronize(home)
        a_err = float((att.float() - attention_plain(*qkv).float()).abs()
                      .max())
        err, tol = testing.gn_sums_check(
            sums, gn.gn_terms_plain(pre.pts, scal, 1.345))
        Tp, okp, itp = gn.gn_solve_plain(pre, T, TrackerConfig())
        t_err = float((T1 - Tp).abs().max())
        same = bool(torch.equal(packed, pack_rows_plain(flat, offs, 0,
                                                        4096)))
        ok = (att.device == sums.device == packed.device == home
              and a_err <= ATTN_TOL["bf16"] and bool((err <= tol).all())
              and ok1 == okp and it1 == itp and t_err <= GN_POSE_ATOL
              and same)
        print(f"kernels on {home} with {other} current: attention max abs "
              f"err {a_err:.3e}, GN sums within tolerance "
              f"{bool((err <= tol).all())}, gn_solve pose {t_err:.3g} "
              f"({it1} / {itp} iterations), pack bitwise {same} [{card}]")
        if not ok:
            raise SystemExit("a kernel launched off the current card "
                             "disagrees with its plain version")
        out[f"{home}_attention_err"] = a_err
        out[f"{home}_gn_solve_pose_abs"] = t_err
    return out


def _nccl_ba_worker(rank, world, addr, path):
    """One process of ``check_nccl_ba``: card ``rank``, the NCCL group, the
    mesh across the processes, the edge- and map-sharded solves of the
    inputs at ``path``; writes its poses, iterations and times."""
    import torch
    import torch.distributed as dist

    from mast3r_slam_torch.ops import ba
    from mast3r_slam_torch.parallel import sharded_ba
    from mast3r_slam_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(addr, world, rank, device="cuda")
    try:
        mesh = make_mesh()
        (_, dev), = mesh.local_edge_entries()
        d = np.load(f"{path}/inputs.npz")
        cfg = ba.BAConfig(**json.loads(str(d["cfg"])))
        res = {}
        for mode, fn in (("edge", sharded_ba.sharded_gauss_newton),
                         ("map", sharded_ba.sharded_gauss_newton_mapshard)):
            args = [torch.from_numpy(d[k]).to(dev) for k in _BA_KEYS]
            for _ in range(2):                      # a warm-up, then timed
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                T, it, _, ok = fn(mesh, *args, "ray",
                                  tuple(int(x) for x in d["img_wh"]), cfg,
                                  return_stats=True)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            res[f"T_{mode}"] = T.cpu().numpy()
            res[f"it_{mode}"] = np.int64(it)
            res[f"ok_{mode}"] = np.bool_(ok)
            res[f"ms_{mode}"] = np.float64((time.perf_counter() - t0) * 1e3)
        np.savez(f"{path}/result_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


_BA_KEYS = ("T0", "Xs", "Cs", "ii", "jj", "idx", "vm", "Q", "ev", "K")


def check_nccl_ba(cards, card):
    """The BA sharded across processes: the oracle drive's graph solved by
    2 and by ``len(cards)`` processes, one card each, joined in an NCCL
    group over a localhost port (``parallel.mesh.init_distributed``; the
    (H, g) reduction an ``all_reduce``), edge and map mode.  Every
    process's poses must be bitwise equal, within ``SHARD_POSE_ATOL`` of
    the single-card solve with its iterations.  Each process is killed
    past ``NCCL_DEADLINE_S``."""
    import multiprocessing as mp
    import socket

    import torch

    from mast3r_slam_torch.ops import ba
    from mast3r_slam_torch.testing import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    system = _oracle_system(seq, "config/eval_no_calib.yaml", True)
    _oracle_run(system, seq)
    _finish(system, "oracle drive for the NCCL BA")
    g = system.graph
    out = {}
    ctx = mp.get_context("spawn")
    for world in sorted({2, len(cards)}):
        sysm = _round_system(system.arena, g, "ray", pose_floor=world)
        inputs = dict(zip(_BA_KEYS, (t.cpu().numpy() for t in
                                     (*sysm, g._K()))))
        T1, it1, _, _ = ba.gauss_newton(
            *(torch.from_numpy(inputs[k]).cuda() for k in _BA_KEYS[:-1]),
            torch.from_numpy(inputs["K"]).cuda(), "ray", (seq.w, seq.h),
            g.cfg)
        T1 = T1.cpu().numpy()
        with tempfile.TemporaryDirectory() as tmp, socket.socket() as sk:
            sk.bind(("localhost", 0))
            addr = f"localhost:{sk.getsockname()[1]}"
            sk.close()
            np.savez(f"{tmp}/inputs.npz", **inputs,
                     cfg=json.dumps(g.cfg._asdict()),
                     img_wh=np.asarray((seq.w, seq.h)))
            procs = [ctx.Process(target=_nccl_ba_worker,
                                 args=(r, world, addr, tmp))
                     for r in range(world)]
            for pr in procs:
                pr.start()
            end = time.monotonic() + NCCL_DEADLINE_S
            for pr in procs:
                pr.join(max(end - time.monotonic(), 1.0))
            hung = [pr for pr in procs if pr.is_alive()]
            for pr in hung:
                pr.kill()
                pr.join()
            if hung or any(pr.exitcode for pr in procs):
                raise SystemExit(f"NCCL BA in {world} processes: exit codes "
                                 f"{[pr.exitcode for pr in procs]}")
            res = [np.load(f"{tmp}/result_{r}.npz") for r in range(world)]
            for mode in ("edge", "map"):
                same = all(np.array_equal(r[f"T_{mode}"], res[0][f"T_{mode}"])
                           for r in res)
                err = float(np.abs(res[0][f"T_{mode}"][:len(T1)]
                                   - T1).max())
                its = [int(r[f"it_{mode}"]) for r in res]
                ms = [float(r[f"ms_{mode}"]) for r in res]
                print(f"sharded BA ({mode}) over NCCL in {world} processes, "
                      f"one card each: poses bitwise equal in every process "
                      f"{same}, {err:.3g} from the single-card solve (limit "
                      f"{SHARD_POSE_ATOL}); iterations {its} (single {it1}); "
                      f"{_r(ms)} ms [{card}]")
                if not (same and err <= SHARD_POSE_ATOL
                        and set(its) == {it1}):
                    raise SystemExit("the NCCL-sharded BA disagrees")
                out[f"nccl_{world}_{mode}_pose_abs"] = err
                out[f"nccl_{world}_{mode}_ms"] = ms
    return out


def multi_card_main(args, cards, peak_flops, peak_bw, card):
    """``--cards N``: only the multi-card phases, across the first N cards:
    the kernels launched with another card current; the network split over
    cards 0 and 1 against the unsplit one, and the production frames
    driven through it; the production drive threaded with the backend on
    card 1 in turns with the drive without it, and once inline; the BA
    sharded over the N cards in one process and over NCCL in 2 and N
    processes; the oracle drive with the backend on card 1."""
    import torch

    from mast3r_slam_torch.testing import production_clip
    from mast3r_slam_torch.utils.config import load_config

    cfg = load_config("config/base.yaml")
    cfg_inline = copy.deepcopy(cfg)
    cfg_inline["single_thread"] = True
    res = {"kernels_off_current": check_kernels_off_current(cards, card)}
    engine, mcfg, sd = build_engine(args.seed)
    # the drives' frames and the one after the last (the pair checks')
    frames = production_clip(args.seed, IMG_HW)
    eng_tp = build_tp_engine(sd, mcfg, devices=cards[:2])
    del sd
    tp = check_tp(engine, eng_tp, mcfg, frames, peak_flops, peak_bw, card)
    launches_tp, system_tp, _, tp["drive"] = drive_frontend(
        eng_tp, mcfg, cfg, frames[:-1], card,
        "tensor-parallel drive over cards 0 and 1")
    del system_tp, eng_tp
    torch.cuda.empty_cache()
    runs = {"backend_device": [], "threaded": []}
    record = None
    for mode in ("backend_device", "threaded", "threaded", "backend_device"):
        launches_b, system_b, rec, t = drive_frontend(
            engine, mcfg, cfg, frames[:-1], card,
            f"production drive, {mode}, run {len(runs[mode]) + 1}",
            backend_device=1 if mode == "backend_device" else None)
        if mode == "backend_device":
            record = rec
            if system_b.graph.idx_ii2jj.device != cards[1]:
                raise SystemExit("the edge store is not on card 1")
        runs[mode].append(t)
        del system_b
        torch.cuda.empty_cache()
    res["backend_device"] = compare_threaded_inline(
        runs, card, "production drive", modes=("backend_device",
                                                "threaded"))
    res["backend_device"]["mirror_rows_copied"] = [
        t["mirror_rows_copied"] for t in runs["backend_device"]]
    _, system_i, _, t_inline = drive_frontend(
        engine, mcfg, cfg_inline, frames[:-1], card,
        "production drive, inline, backend on card 1", backend_device=1)
    res["backend_device"]["inline"] = t_inline
    del system_i
    torch.cuda.empty_cache()
    res["backend_device"].update(drive_oracle_backend_device(card, 1))
    res["sharded_ba"] = check_sharded_ba(record, cfg, card, devices=cards)
    res["nccl_ba"] = check_nccl_ba(cards, card)
    kinds = ("attention", "gn_solve", "pack_rows")
    if not all(launches_tp[k] > 0 and launches_b[k] > 0 for k in kinds):
        raise SystemExit("a kernel of the main path was not launched")
    print(f"tensor parallel over two cards: {json.dumps(tp)}")
    print(f"multi-card: {json.dumps(res)}")
    print(json.dumps({"launches_by_drive": {
        "tp": launches_tp, "backend_device": launches_b}}))
    return 0


def _http_get(port, path):
    """The body of a GET of ``path`` from a viewer on localhost."""
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10).read()


class _ViewerClient:
    """A thread that reads a viewer's ``/meta``, ``/cloud`` and ``/frame``
    every ``VIEWER_POLL_S`` until ``stop`` (five times the page's own
    rate), counting the reads and bytes of each; a failed read other than
    ``/frame`` before the first frame fails the run."""

    def __init__(self, port):
        import threading

        self.port, self.reads, self.errors = port, {}, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        import urllib.error

        while not self._stop.is_set():
            for path in ("/meta", "/cloud", "/frame"):
                try:
                    body = _http_get(self.port, path)
                except urllib.error.HTTPError as e:
                    if path != "/frame" or e.code != 404:
                        self.errors.append(f"{path}: {e}")
                    continue
                except OSError as e:
                    self.errors.append(f"{path}: {e}")
                    continue
                n, size = self.reads.get(path, (0, 0))
                self.reads[path] = (n + 1, size + len(body))
            self._stop.wait(VIEWER_POLL_S)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive() or self.errors:
            raise SystemExit(f"viewer client: {self.errors or 'hung'}")
        return self.reads


def check_viewer(engine, mcfg, cfg, frames, launches, card):
    """The production drive with the live viewer (``main_torch.py`` without
    ``--no-viz``), in turns with the threaded drive without it (viewer,
    without, without, viewer), a client thread reading the viewer's
    endpoints throughout.  Each viewer drive must launch every kernel as
    often as the production drive (``launches``): the viewer launches
    none.  The first one's last served ``/cloud`` must equal, bitwise, the
    blob a fresh viewer builds from the arena copied to the CPU; the
    arena's ``_world_cloud`` and snapshot image on the card are held
    against the CPU copy's."""
    import torch

    from mast3r_slam_torch import viz
    from mast3r_slam_torch.frame import arena_copy
    from mast3r_slam_torch.viz_server import LiveViewer

    runs = {"viewer": [], "without": []}
    out = {}
    for mode in ("viewer", "without", "without", "viewer"):
        label = (f"production drive, {'with' if mode == 'viewer' else mode}"
                 f" the viewer, run {len(runs[mode]) + 1}")
        viewer = client = None
        if mode == "viewer":
            viewer = LiveViewer(port=0)
            client = _ViewerClient(viewer.port)
        try:
            n_launch, system, _, t = drive_frontend(
                engine, mcfg, cfg, frames, card, label, viewer=viewer)
            if viewer is not None:
                served = _http_get(viewer.port, "/cloud")
                t["client_reads"] = client.stop()
                client = None
        finally:
            if client is not None:
                client.stop()
            if viewer is not None:
                viewer.close()
        runs[mode].append(t)
        if mode == "viewer":
            for k in ("attention", "pack_rows", "gn_solve"):
                if n_launch[k] != launches[k]:
                    raise SystemExit(f"{label}: {k} launches "
                                     f"{n_launch[k]} against the production "
                                     f"drive's {launches[k]}")
            print(f"{label}: client reads (count, bytes) "
                  f"{t['client_reads']}; launches {n_launch} equal the "
                  f"production drive's [{card}]")
            out.setdefault("launches", n_launch)
        if mode == "viewer" and len(runs[mode]) == 1:
            cpu = arena_copy(system.arena, "cpu")
            fresh = LiveViewer(port=0)
            try:
                t0 = time.perf_counter()
                fresh.publish(cpu, stats=system.stats)
                t1 = time.perf_counter()
                fresh.publish(cpu, stats=system.stats)
                t2 = time.perf_counter()
            finally:
                fresh.close()
            if served != fresh._blob:
                raise SystemExit(f"{label}: the served blob is not the one "
                                 f"built from the arena's CPU copy")
            # where a publish's host time goes, on the CPU copy (no copies
            # from the card): each row's grid, then the composition
            h, w = cpu.img_hw
            extract_ms = []
            for i in range(cpu.n_size):
                t3 = time.perf_counter()
                viz.extract_kf_grid(cpu.X[i].numpy(), cpu.C[i].numpy(),
                                    int(cpu.N[i]), cpu.uimg[i].numpy(), h,
                                    w, 1, 1.5)
                extract_ms.append((time.perf_counter() - t3) * 1e3)
            out.update(cpu_publish_cold_ms=(t1 - t0) * 1e3,
                       cpu_publish_warm_ms=(t2 - t1) * 1e3,
                       extract_row_ms=extract_ms)
            print(f"{label}: on the arena's CPU copy a cold publish "
                  f"({cpu.n_size} rows) takes {out['cpu_publish_cold_ms']:.1f}"
                  f" ms, a warm one (compose + blob) "
                  f"{out['cpu_publish_warm_ms']:.1f} ms, one row's grid "
                  f"{_r(extract_ms)} ms (host clock) [{card}]")
            pts, cols = viz._world_cloud(system.arena)
            pts_c, cols_c = viz._world_cloud(cpu)
            if pts.shape != pts_c.shape or not np.array_equal(cols, cols_c):
                raise SystemExit(f"{label}: _world_cloud keeps other points "
                                 f"on the card than on the CPU")
            err = float(np.abs(pts - pts_c).max())
            scale = float(np.abs(pts_c).max())
            img = viz.snapshot_image(system.arena)
            img_c = viz.snapshot_image(cpu)
            agree = float((img == img_c).all(-1).mean())
            out.update(blob_bytes=len(served), world_cloud_points=len(pts),
                       world_cloud_max_abs_err=err,
                       world_cloud_scale=scale,
                       world_cloud_equal_share=float(
                           (pts == pts_c).all(-1).mean()),
                       snapshot_pixels_equal=agree)
            print(f"{label}: served blob ({len(served)} bytes) bitwise the "
                  f"CPU copy's; _world_cloud {len(pts)} points, max abs "
                  f"difference card against CPU {err:.3g} (scale "
                  f"{scale:.3g}), {out['world_cloud_equal_share']:.6f} "
                  f"equal; snapshot pixels equal {agree:.6f} [{card}]")
            if err > VIEWER_CLOUD_RTOL * (1.0 + scale) or \
                    agree < VIEWER_SNAPSHOT_AGREE:
                raise SystemExit(f"{label}: the card's map export disagrees "
                                 f"with the CPU's")
        del system
        torch.cuda.empty_cache()
    out.update(compare_threaded_inline(runs, card, "production drive",
                                       modes=("viewer", "without")))
    for k in ("publish_ms", "publish_rows", "publish_bytes",
              "frame_png_ms", "client_reads"):
        out[k] = [t[k] for t in runs["viewer"]]
    return out


def check_viewer_pause(card):
    """Pause and single step through ``main_torch.run(..., viewer=)`` on
    the card, over 6 frames of the 16-frame oracle clip (backend inline):
    paused before the first frame nothing runs, each step lets exactly one
    frame through, unpausing lets the run finish.  Each wait has a
    deadline."""
    import threading

    import main_torch
    from mast3r_slam_torch.testing import ClipDataset, SyntheticSequence
    from mast3r_slam_torch.viz_server import LiveViewer

    seq = SyntheticSequence(n_frames=16, h=48, w=64, seed=0, traj_scale=0.5)
    system = _oracle_system(seq, "config/eval_no_calib.yaml", True)
    frames, errors = [], []
    process = system.process_frame

    def counted(i, img):
        frames.append(i)
        return process(i, img)

    system.process_frame = counted
    viewer = LiveViewer(port=0)

    def loop():
        try:
            main_torch.run(system, ClipDataset(seq.images[:6]),
                           main_torch.parse_args(["--no-viz"]),
                           viewer=viewer)
        except Exception as e:  # reported below
            errors.append(e)

    def wait(cond):
        end = time.monotonic() + VIEWER_WAIT_S
        while not cond():
            if time.monotonic() > end:
                raise SystemExit(f"viewer pause / step: no progress in "
                                 f"{VIEWER_WAIT_S} s (frames {frames})")
            time.sleep(0.005)

    steps = []
    try:
        _http_get(viewer.port, "/ctrl?pause=1")
        thread = threading.Thread(target=loop, daemon=True)
        thread.start()
        time.sleep(VIEWER_HOLD_S)
        steps.append(list(frames))
        for k in (1, 2):
            _http_get(viewer.port, "/ctrl?step=1")
            wait(lambda: len(frames) >= k)
            time.sleep(VIEWER_HOLD_S)
            steps.append(list(frames))
        _http_get(viewer.port, "/ctrl?pause=0")
        thread.join(timeout=VIEWER_WAIT_S)
        if thread.is_alive() or errors:
            raise SystemExit(f"viewer pause / step: the run did not end "
                             f"({errors})")
    finally:
        viewer.close()
    if steps != [[], [0], [0, 1]] or frames != list(range(6)):
        raise SystemExit(f"viewer pause / step: frames {steps} then "
                         f"{frames}")
    print(f"viewer pause / step on the card: paused {steps[0]}, one step "
          f"{steps[1]}, two {steps[2]}, unpaused {frames}; "
          f"{viewer._meta['nkf']} keyframes published [{card}]")
    return {"pause_step_frames": steps + [frames]}


def check_downsample(engine, frames, card):
    """``dataset.img_downsample`` 2 on the ViT-L engine: ``decode_pair``'s
    outputs against the ``downsample=1`` outputs strided by 2, bitwise;
    one ``match_asymmetric`` at 192x256 with kernel C's launches counted
    (as many as a full match has tables at that size)."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.ops.pack import pack_rows

    eng2 = InferenceEngine(engine.model, IMG_HW, downsample=2,
                           match_cfg=engine.match_cfg, device="cuda")
    norm = [torch.from_numpy(f.astype(np.float32) * (1.0 / 127.5) - 1.0)
            [None].cuda() for f in frames[:2]]
    (f1, p1), (f2, p2) = (engine.encode(x) for x in norm)
    full = engine.decode_pair(f1, p1, f2, p2)
    half = eng2.decode_pair(f1, p1, f2, p2)
    for view, (A1, A2) in enumerate(zip(full, half)):
        for name, a, b in zip("XCDQ", A1, A2):
            if tuple(b.shape[1:3]) != eng2.out_hw or \
                    not torch.equal(a[:, ::2, ::2], b):
                raise SystemExit(f"downsample 2: {name}{view + 1} is not the "
                                 f"strided full output")
    torch.cuda.synchronize()
    pack_rows.launches = 0
    idx, valid, *_ = eng2.match_asymmetric(f2, p2, f1, p1)
    torch.cuda.synchronize()
    n_pack = pack_rows.launches
    expect = len(pack_tables(eng2.match_cfg, eng2.out_hw))
    hw = eng2.out_hw[0] * eng2.out_hw[1]
    if tuple(idx.shape) != (1, hw) or n_pack != expect:
        raise SystemExit(f"downsample 2: match_asymmetric gave {idx.shape} "
                         f"with {n_pack} pack launches ({expect} expected)")
    print(f"downsample 2: decode_pair outputs {eng2.out_hw} bitwise the "
          f"strided full ones; match_asymmetric {tuple(idx.shape)}, valid "
          f"share {float(valid.float().mean()):.3f}, pack launches {n_pack} "
          f"[{card}]")
    return {"out_hw": list(eng2.out_hw), "pack_launches": n_pack,
            "valid_share": float(valid.float().mean())}


def write_published_checkpoint(sd, mcfg, path):
    """``sd`` saved as a MASt3R training run saves it, the layout of the
    published ``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth``: a
    dict with the run's ``argparse.Namespace`` under ``"args"`` (its
    ``model`` string) and the state dict under ``"model"``, with
    ``dec_blocks2``, the DPT's ``scratch.layer_rn`` aliases and the CroCo
    ``mask_token``.  The conditioned weights tie the second decoder and
    head to the first, and ``torch.save`` writes a storage its tensors
    share once, so the file is smaller than a published one.  Returns the
    file's bytes and the write seconds."""
    import os

    import torch

    for k in ("dec_blocks2.0.attn.qkv.weight",
              "downstream_head1.dpt.scratch.layer_rn.0.weight"):
        if k not in sd:
            raise SystemExit(f"the state dict has no {k}: not the published "
                             f"layout")
    model_args = (
        f"AsymmetricMASt3R(enc_depth={mcfg.enc_depth}, "
        f"dec_depth={mcfg.dec_depth}, enc_embed_dim={mcfg.enc_embed_dim}, "
        f"dec_embed_dim={mcfg.dec_embed_dim}, "
        f"enc_num_heads={mcfg.enc_num_heads}, "
        f"dec_num_heads={mcfg.dec_num_heads}, head_type='catmlp+dpt', "
        f"output_mode='pts3d+desc{mcfg.local_feat_dim}', "
        f"patch_size={mcfg.patch_size}, img_size=(512, 512))")
    t0 = time.perf_counter()
    torch.save({"args": argparse.Namespace(model=model_args),
                "model": {**sd, "mask_token": torch.zeros(
                    1, 1, mcfg.dec_embed_dim)}}, path)
    return os.path.getsize(path), time.perf_counter() - t0


def check_checkpoint(engine, sd, mcfg, frames, path, card):
    """The conditioned ViT-L f32 weights (``sd``) written as a published
    checkpoint file, loaded through ``main_torch.load_model`` (``--checkpoint``:
    ``models/convert.py::load_checkpoint``): every tensor must equal
    ``sd``'s, the engine built from the loaded model must hold the
    production engine's tensors, and one encode of two frames and their
    ``decode_pair`` through both engines must be bitwise equal.  The file's
    bytes and its write, read and load seconds are on the host clock."""
    import torch

    import main_torch
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models import convert

    nbytes, write_s = write_published_checkpoint(sd, mcfg, path)
    read_s = []

    def timed_read(fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        read_s.append(time.perf_counter() - t0)
        return res

    spy = _Spy(convert, "load_torch_checkpoint", timed_read)
    try:
        t0 = time.perf_counter()
        model = main_torch.load_model(
            main_torch.parse_args(["--checkpoint", path]))
        load_s = time.perf_counter() - t0
    finally:
        spy.restore()
    if len(read_s) != 1:
        raise SystemExit("main_torch.load_model did not read the checkpoint "
                         "through load_torch_checkpoint")
    got = model.state_dict()
    if set(got) != set(sd) or not all(torch.equal(got[k], sd[k])
                                      for k in sd):
        raise SystemExit("the checkpoint loaded by main_torch.load_model "
                         "does not hold the written weights")
    eng = InferenceEngine(model, IMG_HW, device="cuda")
    mine, ref = eng.model.state_dict(), engine.model.state_dict()
    if set(mine) != set(ref) or not all(torch.equal(mine[k], ref[k])
                                        for k in ref):
        raise SystemExit("the engine of the loaded checkpoint does not hold "
                         "the production engine's tensors")
    norm = [torch.from_numpy(f.astype(np.float32) * (1.0 / 127.5) - 1.0)
            [None].cuda() for f in frames[:2]]
    outs = []
    for e in (engine, eng):
        (f1, p1), (f2, p2) = (e.encode(x) for x in norm)
        outs.append([f1, p1, f2, p2] + [a for view in e.decode_pair(
            f1, p1, f2, p2) for a in view])
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise SystemExit("encode + decode_pair of the loaded checkpoint is "
                         "not bitwise the production engine's")
    out = {"file_bytes": nbytes, "write_s": write_s, "read_s": read_s[0],
           "load_model_s": load_s, "tensors": len(sd),
           "encode_decode_bitwise": True}
    print(f"checkpoint: the published layout ({len(sd)} tensors + "
          f"mask_token, {nbytes} bytes) written in {write_s:.1f} s; "
          f"main_torch.load_model read it in {read_s[0]:.1f} s and built "
          f"and loaded the ViT-L network in {load_s:.1f} s (host clock); "
          f"every tensor equal to the written ones, the engine's to the "
          f"production engine's, encode + decode_pair bitwise [{card}]")
    del eng, model
    torch.cuda.empty_cache()
    return out


def drive_cli(ckpt, frames, tmp, card):
    """``main_torch.main`` as a user runs it, in process: ``frames`` written
    as a clip folder of PNGs, ``--config config/base.yaml`` unmodified
    (threaded backend, bf16 heads), ``--checkpoint`` the published file,
    ``--no-viz``.  Every kernel's count is set to 0 just before the call
    and read just after.  Returns its launches, stats, keyframe poses and
    times."""
    import os

    import torch
    from PIL import Image

    import main_torch
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.pack import pack_rows

    clip = f"{tmp}/clip"
    os.makedirs(clip)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(f"{clip}/{i:06d}.png")
    kept = {}

    def keep(fn, system, dataset, args, **kw):
        res = fn(system, dataset, args, **kw)
        kept.update(system=system, summary=res)
        return res

    spy = _Spy(main_torch, "run", keep)
    try:
        torch.cuda.synchronize()
        flash_attention.launches = pack_rows.launches = 0
        gn.gn_sums.launches = gn.gn_solve.launches = 0
        t0 = time.perf_counter()
        rc = main_torch.main([
            "--dataset", clip, "--config", "config/base.yaml",
            "--checkpoint", ckpt, "--no-viz", "--save-as", f"{tmp}/run",
            "--rates-out", f"{tmp}/rates.json"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"attention": flash_attention.launches,
                    "gn_accumulate": gn.gn_sums.launches,
                    "gn_solve": gn.gn_solve.launches,
                    "pack_rows": pack_rows.launches}
    finally:
        spy.restore()
    system, summary = kept["system"], kept["summary"]
    launches["gn_iterations"] = system.tracker.gn_iters_total
    n_kf = system.arena.n_size
    kf = system.arena.T_WC[:n_kf].cpu()
    traj = np.loadtxt(f"{tmp}/run/clip.txt", ndmin=2)
    if rc != 0 or summary["frames"] != len(frames) or \
            summary["lost_at"] is not None or len(traj) != n_kf or \
            not bool(torch.isfinite(kf).all()):
        raise SystemExit(f"main_torch.main from the PNG clip failed: exit "
                         f"{rc}, {summary['frames']} frames, lost at "
                         f"{summary['lost_at']}, {len(traj)} trajectory rows "
                         f"for {n_kf} keyframes")
    print(f"main_torch.main from {len(frames)} PNGs with the checkpoint "
          f"file and config/base.yaml: {wall_s:.1f} s in all (load, drive, "
          f"export; host clock), drive {summary['seconds']:.2f} s, stats "
          f"{summary['stats']}, launches {launches} [{card}]")
    return {"launches": launches, "stats": summary["stats"], "kf": kf,
            "main_s": wall_s, "drive_s": summary["seconds"]}


def compare_cli_drive(cli, launches, bf16_drive, card):
    """The CLI drive from disk against the in-memory production drive:
    equal launches of every kernel and equal stats; the largest keyframe
    pose difference is printed (a finding, not a gate)."""
    for k in ("attention", "gn_accumulate", "gn_solve", "pack_rows"):
        if cli["launches"][k] != launches[k]:
            raise SystemExit(f"CLI drive: {k} launches {cli['launches'][k]} "
                             f"against the production drive's {launches[k]}")
    if cli["stats"] != bf16_drive["timings"]["stats"]:
        raise SystemExit(f"CLI drive: stats {cli['stats']} against the "
                         f"production drive's "
                         f"{bf16_drive['timings']['stats']}")
    kf, ref = cli.pop("kf"), bf16_drive["kf"]
    cli["kf_pose_max_abs_diff"] = float((kf - ref).abs().max()) \
        if kf.shape == ref.shape else None
    print(f"CLI drive against the in-memory production drive: launches and "
          f"stats equal, keyframe poses {cli['kf_pose_max_abs_diff']} apart "
          f"(largest absolute difference) [{card}]")
    return cli


def run_tool(argv, timeout, label, env=None):
    """``python`` with ``argv`` from the repository root, in a session of
    its own so that a timeout kills its whole process tree; fails the run
    on a non-zero exit or a timeout.  The timeout ends before the script's
    watchdog would, which could not stop the tree.  ``env`` replaces the
    environment.  Returns its output (standard output and error)."""
    import os
    import signal

    timeout = min(timeout, _DEADLINE[0] - time.monotonic() - 10.0)
    if timeout <= 0:
        raise SystemExit(f"{label}: no time left before the watchdog")
    proc = subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=env)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out)
        raise SystemExit(f"{label}: no exit within {timeout:.0f} s")
    if proc.returncode != 0:
        print(out)
        raise SystemExit(f"{label}: exit {proc.returncode}")
    return out


# tools/eval_protocol.py over a suite of one clip, its logs under a root of
# its own (``LOGS``): argv[1:4] are the logs root, the suite's dataset root
# and the --main-args string
EVAL_PROTOCOL_RUN = """
import pathlib, sys
from mast3r_slam_torch.tools import eval_protocol as ep
logs, root, main_args = sys.argv[1:4]
ep.LOGS = pathlib.Path(logs)
ep.SUITES["synthetic"] = ep.Suite("synthetic", ["clip"], root, "dataset",
                                  0.05)
sys.exit(ep.main(["synthetic", "--no-calib", "--main-args", main_args]))
"""


def check_eval_tools(card):
    """The evaluation tools on the card's machine, each a process under a
    deadline: ``tools/make_synthetic_clip`` writes the 48-frame 48x64 clip;
    ``tools/eval_protocol`` runs ``main_torch.py --oracle`` over it at
    ``config/eval_no_calib.yaml`` on the card and again with ``--cpu``: both
    ATEs under the 0.05 m limit and within ``ORACLE_ATE_CPU_ATOL`` of each
    other; ``tools/analyze_drive`` reads the card run's ``--diag-out``;
    ``tools/segmented_drive`` runs the clip on the card in 3 segments, whose
    trajectory must hold the one-process card run's keyframes, poses within
    ``ORACLE_RESUME_ATOL``."""
    import shutil

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = f"{tmp}/suite/clip"
        t0 = time.perf_counter()
        run_tool(["-m", "mast3r_slam_torch.tools.make_synthetic_clip", clip,
                  str(EVAL_CLIP[0]), str(EVAL_CLIP[1]), str(EVAL_CLIP[2])],
                 TOOL_TIMEOUT_S, "make_synthetic_clip")
        shutil.copy(f"{clip}/gt.txt", f"{clip}/groundtruth.txt")
        out["make_synthetic_clip_s"] = time.perf_counter() - t0
        ates, trajs = {}, {}
        for dev, extra in (("card", f"--diag-out {tmp}/diag.jsonl"),
                           ("cpu", "--cpu")):
            logs = f"{tmp}/logs_{dev}"
            t0 = time.perf_counter()
            text = run_tool(["-c", EVAL_PROTOCOL_RUN, logs, f"{tmp}/suite",
                             f"--oracle {extra} --rates-out "
                             f"{tmp}/rates_{dev}.json"],
                            TOOL_TIMEOUT_S, f"eval_protocol ({dev})")
            out[f"eval_protocol_{dev}_s"] = time.perf_counter() - t0
            with open(f"{logs}/ate_synthetic_no_calib_torch.json") as f:
                table = json.load(f)
            ates[dev] = table["ate_rmse"]["clip"]
            trajs[dev] = np.loadtxt(
                f"{logs}/synthetic/no_calib/clip/clip.txt", ndmin=2)
            print(f"eval_protocol ({dev}): "
                  + " | ".join(ln.strip() for ln in text.splitlines()
                               if ln.startswith(("stats:", "  clip")))
                  + f" [{card}]")
        diff = abs(ates["card"] - ates["cpu"])
        out.update(ate_card=ates["card"], ate_cpu=ates["cpu"],
                   ate_card_cpu_diff=diff)
        print(f"eval_protocol: ATE {ates['card']!r} m on the card, "
              f"{ates['cpu']!r} m on the CPU, {diff:.3g} apart (limit "
              f"{ORACLE_ATE_CPU_ATOL}) [{card}]")
        if not max(ates.values()) < ORACLE_ATE_LIMIT["uncalibrated"] or \
                diff > ORACLE_ATE_CPU_ATOL:
            raise SystemExit("eval_protocol: the card's ATE fails its limit "
                             "or the CPU's")
        est = f"{tmp}/logs_card/synthetic/no_calib/clip/clip.txt"
        report = run_tool(["-m", "mast3r_slam_torch.tools.analyze_drive",
                           f"{tmp}/diag.jsonl", clip, "--est", est],
                          TOOL_TIMEOUT_S, "analyze_drive")
        lines = report.splitlines()
        if not lines or "diag rows" not in lines[0] or \
                "final keyframe poses vs GT (post-BA):" not in lines:
            raise SystemExit("analyze_drive printed no report")
        out["analyze_drive_lines"] = len(lines)
        print(f"analyze_drive on the card run's --diag-out: {len(lines)} "
              f"lines, {lines[0]}; "
              + "; ".join(ln.strip() for ln in lines
                          if ln.startswith(("frames:", "keyframe "))))
        t0 = time.perf_counter()
        text = run_tool(["-m", "mast3r_slam_torch.tools.segmented_drive",
                         "--dataset", clip, "--config",
                         "config/eval_no_calib.yaml", "--segment",
                         str(EVAL_SEGMENT), "--save-as", f"{tmp}/seg",
                         "--rates-out", f"{tmp}/rates_seg.json", "--oracle"],
                        3 * TOOL_TIMEOUT_S, "segmented_drive")
        out["segmented_drive_s"] = time.perf_counter() - t0
        seg = np.loadtxt(f"{tmp}/seg/clip.txt", ndmin=2)
        one = trajs["card"]
        same_rows = seg.shape == one.shape and \
            np.array_equal(seg[:, 0], one[:, 0])
        err = float(np.abs(seg - one).max()) if same_rows else float("inf")
        with open(f"{tmp}/seg/clip.txt") as f, open(est) as g:
            bitwise = f.read() == g.read()
        out.update(segments=text.count("[segment "),
                   segmented_pose_max_abs_diff=err,
                   segmented_bitwise=bitwise)
        print(f"segmented_drive on the card: {out['segments']} segments, "
              f"{len(seg)} keyframes against {len(one)} in one process, "
              f"trajectory {err:.3g} apart (limit {ORACLE_RESUME_ATOL}), "
              f"file byte for byte {out['segmented_bitwise']}; "
              f"{out['segmented_drive_s']:.1f} s [{card}]")
        if out["segments"] != 3 or not err <= ORACLE_RESUME_ATOL:
            raise SystemExit("segmented_drive differs from the one-process "
                             "run")
    return out


def check_bench(card):
    """``python3 bench_torch.py`` (the tracked-FPS benchmark, ViT-L at
    384x512 on the card) as a process under a deadline, with
    ``BENCH_CHAIN`` calls a stage.  Its last line must hold
    ``tools.bench.check_record``: ``bench.py``'s keys and
    ``drive_tracked_frame``, every stage positive, the tracked rate
    1000 / (encode + track), ``vs_baseline`` value / 15 and ``value`` the
    composition of the printed stages and rates; the drive must have
    tracked; and its log's launch line must show kernels A, C and
    ``gn_solve`` launched in that process.  Returns the record, the
    launches and the stages' host, CUDA-event and busy times."""
    import os
    import re

    from mast3r_slam_torch.tools.bench import check_record

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_CHAIN"] = str(BENCH_CHAIN)
    t0 = time.perf_counter()
    text = run_tool(["bench_torch.py"], BENCH_TIMEOUT_S, "bench_torch",
                    env=env)
    seconds = time.perf_counter() - t0
    lines = text.splitlines()
    records = [ln for ln in lines if ln.startswith('{"metric"')]
    launch = [re.fullmatch(r"bench_torch: launches attention (\d+) pack "
                           r"(\d+) gn_solve (\d+) gn_accumulate (\d+)",
                           ln) for ln in lines]
    launch = [m for m in launch if m]
    stages = [ln for ln in lines if ln.startswith("stages (host ms")]
    if len(records) != 1 or len(launch) != 1 or len(stages) != 1:
        print(text)
        raise SystemExit("bench_torch: no single record, launch line and "
                         "stage line")
    rec = json.loads(records[0])
    try:
        check_record(rec)
    except ValueError as e:
        print(text)
        raise SystemExit(f"bench_torch: {e}")
    if rec["breakdown_ms"]["drive_tracked_frame"] is None:
        raise SystemExit("bench_torch: the drive tracked no frame")
    n = dict(zip(("attention", "pack_rows", "gn_solve", "gn_accumulate"),
                 map(int, launch[0].groups())))
    if not all(n[k] > 0 for k in ("attention", "pack_rows", "gn_solve")):
        raise SystemExit(f"bench_torch: a kernel of the main path was not "
                         f"launched in the bench process: {n}")
    for ln in lines:
        if ln.startswith(("frame:", "protocol:", "  threaded-1chip",
                          "  drive (", "  2chip")):
            print(ln)
    print(f"bench_torch: launches {n}, {seconds:.1f} s, BENCH_CHAIN "
          f"{BENCH_CHAIN} [{card}]")
    return {"record": rec, "launches": n, "seconds": seconds,
            "stages": json.loads(stages[0].split(": ", 1)[1])}


def device_busy(fn, top=12):
    """``tools.bench.device_busy`` on the card, printing the ``top``
    kernels by time: the summed device time of one traced call of ``fn``
    and the number of kernels launched.  Fails when the profiler sees no
    device time."""
    import torch

    from mast3r_slam_torch.tools.bench import device_busy as busy

    ms, n = busy(fn, torch.device("cuda", torch.cuda.current_device()),
                 top=top, out=sys.stdout)
    if ms is None:
        raise SystemExit("the profiler saw no device time")
    return ms, n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the multi-card phases across this many "
                         "cards (needs as many; without it the script "
                         "needs one card and runs every other phase)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # no phase can hang: past the deadline the tracebacks are printed and
    # the process exits 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    _DEADLINE[0] = time.monotonic() + WATCHDOG_S
    from mast3r_slam_torch import _build

    # f32 products stay f32 on the card (no TF32), in every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)

    t0 = time.perf_counter()
    logs = _build.build(["attention", "gn", "pack"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"  {src}: {line.strip()}")

    tc_ops = tensor_core_instructions()
    if args.cards > 1:
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"--cards {args.cards}: "
                             f"{torch.cuda.device_count()} cards present")
        rc = multi_card_main(args, [torch.device("cuda", i)
                                    for i in range(args.cards)],
                             peak_flops, peak_bw, card)
        faulthandler.cancel_dump_traceback_later()
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return rc

    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.testing import make_clip, production_clip
    from mast3r_slam_torch.tracker import TrackerConfig
    from mast3r_slam_torch.utils.config import (apply_reference_exact,
                                                load_config)

    cfg = load_config("config/base.yaml")       # as written
    if cfg["single_thread"]:
        raise SystemExit("config/base.yaml no longer selects the threaded "
                         "backend")
    cfg_exact = apply_reference_exact(cfg)
    cfg_inline = copy.deepcopy(cfg)
    cfg_inline["single_thread"] = True

    attn = check_attention(peak_flops, peak_bw, card)
    gnt = check_gn(peak_bw, card)
    gnst = check_gn_solve(TrackerConfig.from_config(cfg), peak_bw, card)
    packt = check_pack(MatchingConfig.from_dict(cfg["matching"]), peak_bw,
                       card)
    check_small_model()

    engine, mcfg, sd = build_engine(args.seed)
    # the drives' frames and the one after the last (the pair checks')
    frames = production_clip(args.seed, IMG_HW)
    heads = check_heads(engine, sd, frames, card)
    eng_q, eng_l, int8 = check_int8(engine, sd, mcfg, frames, peak_flops,
                                    peak_bw, card)
    int8.update(check_int8_local_head(eng_q, eng_l, frames, card))
    eng_tp = build_tp_engine(sd, mcfg)
    # the same weights as a published checkpoint file, loaded through
    # main_torch.load_model; then main_torch.main from a PNG clip with it
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = check_checkpoint(engine, sd, mcfg, frames,
                                      f"{tmp}/checkpoint.pth", card)
        del sd, eng_l
        torch.cuda.empty_cache()
        cli = drive_cli(f"{tmp}/checkpoint.pth", frames[:-1], tmp,
                        card)
    checkpoint.update(card=card)
    tp = check_tp(engine, eng_tp, mcfg, frames, peak_flops, peak_bw, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches, system, record, timings = drive_frontend(
            engine, mcfg, cfg, frames[:-1], card, "production drive",
            state_out=f"{tmp}/state.npz")
        state = check_state(system, engine, f"{tmp}/state.npz",
                            timings.pop("state_save_s"), card)
    stages = breakdown(system, frames[-1], card, "production")
    stages.update({k: v for k, v in heads.items()
                   if k.endswith(("_ms", "_kernels"))})
    stages.update(timings)
    stages.update(check_ba(record, cfg, card))
    multi = {"sharded_ba": check_sharded_ba(record, cfg, card)}
    stages.update(backend_breakdown(system, record, card))
    stages.update(network_breakdown_report(engine, stages, card))
    bf16_drive = {"timings": timings,
                  "kf": system.arena.T_WC[:system.arena.n_size].cpu(),
                  "last": system.last_T_WC.cpu()}
    cli = compare_cli_drive(cli, launches, bf16_drive, card)
    del system, record
    torch.cuda.empty_cache()
    # the same frames inline, in turns with a second threaded drive
    # (threaded, inline, inline, threaded)
    runs = {"threaded": [timings], "inline": []}
    for mode, c in (("inline", cfg_inline), ("inline", cfg_inline),
                    ("threaded", cfg)):
        launches_again, system_again, _, t = drive_frontend(
            engine, mcfg, c, frames[:-1], card,
            f"production drive, {mode}, run {len(runs[mode]) + 1}")
        runs[mode].append(t)
        del system_again
        torch.cuda.empty_cache()
    stages.update(compare_threaded_inline(runs, card, "production drive"))
    # the same frames through the int8 encoder (main_quantized_torch.py),
    # threaded as the production drive
    launches_int8, system_int8, _, timings_int8 = drive_frontend(
        eng_q, mcfg, cfg, frames[:-1], card, "int8 drive")
    int8["drive"] = timings_int8
    int8["drive"].update(compare_int8_drive(bf16_drive, {
        "timings": timings_int8,
        "kf": system_int8.arena.T_WC[:system_int8.arena.n_size].cpu(),
        "last": system_int8.last_T_WC.cpu()}, card))
    del system_int8, eng_q
    torch.cuda.empty_cache()
    # the same frames through the engine split over two entries of the card
    # (--tp 2), threaded
    launches_tp, system_tp, _, tp["drive"] = drive_frontend(
        eng_tp, mcfg, cfg, frames[:-1], card, "tensor-parallel drive")
    del system_tp, eng_tp
    torch.cuda.empty_cache()
    # the same frames threaded with the backend on device 0 (its mirror
    # arena beside the live one), in turns with the threaded drive without
    # it (backend device, without, without, backend device)
    bdev_runs = {"backend_device": [], "threaded": []}
    for mode in ("backend_device", "threaded", "threaded", "backend_device"):
        n_launch, system_b, _, t = drive_frontend(
            engine, mcfg, cfg, frames[:-1], card,
            f"production drive, {mode}, run {len(bdev_runs[mode]) + 1}",
            backend_device=0 if mode == "backend_device" else None)
        if mode == "backend_device" and not bdev_runs[mode]:
            launches_bdev = n_launch
        bdev_runs[mode].append(t)
        del system_b
        torch.cuda.empty_cache()
    multi["backend_device"] = compare_threaded_inline(
        bdev_runs, card, "production drive", modes=("backend_device",
                                                    "threaded"))
    multi["backend_device"]["mirror_rows_copied"] = [
        t["mirror_rows_copied"] for t in bdev_runs["backend_device"]]
    # the same frames with the live viewer, in turns with the threaded
    # drive without it; pause / step on the oracle clip; img_downsample 2
    viewer = check_viewer(engine, mcfg, cfg, frames[:-1], launches,
                          card)
    launches_viewer = viewer.pop("launches")
    viewer.update(check_viewer_pause(card))
    viewer["downsample"] = check_downsample(engine, frames, card)

    from mast3r_slam_torch.retrieval.database import RetrievalDatabase

    loop = make_clip(args.seed, N_FRAMES_LOOP_OUT, IMG_HW, LOOP_SHIFT,
                     LOOP_TEXTURE)
    with tempfile.TemporaryDirectory() as tmp:
        files = forge_retrieval_files(tmp, args.seed, mcfg.enc_embed_dim)
        t0 = time.perf_counter()
        db = RetrievalDatabase.from_checkpoint(*files, device="cuda")
        print(f"retrieval database: {db.codebook.size} x "
              f"{db.codebook.dim} codebook on the card, loaded in "
              f"{time.perf_counter() - t0:.1f} s")
        launches_retr, system_retr, pairs, retrieval = drive_retrieval(
            engine, mcfg, cfg, loop + loop[-2::-1], db, card)
        retrieval.update(check_desc_global(system_retr, pairs[0], card))
        del system_retr, db
        torch.cuda.empty_cache()
        # the same clip inline, with a fresh database of the same files
        db = RetrievalDatabase.from_checkpoint(*files, device="cuda")
        _, system_retr, _, retrieval_inline = drive_retrieval(
            engine, mcfg, cfg_inline, loop + loop[-2::-1], db, card,
            label="retrieval drive, inline")
        del system_retr, db
        torch.cuda.empty_cache()
    retrieval.update(compare_threaded_inline(
        {"threaded": [retrieval], "inline": [retrieval_inline]}, card,
        "retrieval drive"))
    _, system_exact, _, timings_exact = drive_frontend(
        engine, mcfg, cfg_exact, frames[:N_FRAMES_REFERENCE_EXACT], card,
        "reference-exact drive")
    stages_exact = breakdown(system_exact,
                             frames[N_FRAMES_REFERENCE_EXACT], card,
                             "reference-exact", full=False)
    stages_exact.update(timings_exact)
    del system_exact
    ate = drive_oracle(card)
    ate["loop_retrieval"] = drive_oracle_loop(card)
    ate["threaded"] = drive_oracle_threaded(card)
    state.update(drive_oracle_state(card))
    multi["backend_device"].update(drive_oracle_backend_device(card))
    tools = check_eval_tools(card)
    torch.cuda.empty_cache()
    bench = check_bench(card)

    # the main path's launches: each drive's, counted from 0 over its own
    # run
    kinds = ("attention", "gn_accumulate", "gn_solve", "pack_rows")
    drives = {"production": launches, "retrieval": launches_retr,
              "int8": launches_int8, "tp": launches_tp,
              "backend_device": launches_bdev, "viewer": launches_viewer,
              "cli": cli["launches"]}
    # the GN iterations of the drives in this process (the bench process's
    # track calls each run its cadence's, refused otherwise)
    gn_iterations = sum(n["gn_iterations"] for n in drives.values())
    drives["bench"] = bench["launches"]
    by_drive = {k: {d: n[k] for d, n in drives.items()} for k in kinds}
    for d in ("retrieval", "int8", "tp", "backend_device", "viewer", "cli",
              "bench"):
        if not all(drives[d][k] > 0
                   for k in ("attention", "gn_solve", "pack_rows")):
            raise SystemExit(f"a kernel of the main path was not launched "
                             f"by the {d} drive")
    launches = {k: sum(n[k] for n in drives.values()) for k in kinds}
    kernels = [
        dict(name="attention", route="cuda",
             source="mast3r_slam_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:28",
             launches=launches["attention"],
             launches_by_drive=by_drive["attention"], tensor_core_sass=tc_ops,
             launches_per_encode_tp=tp["tp_attention_launches_per_encode"],
             launches_per_decode_tp=tp["tp_attention_launches_per_decode"],
             tp_shapes=tp["attention_tp_shapes"], **attn["encoder"]),
        # the sums' arithmetic (accumulate_point) reaches the card through
        # two entries: its count is the launches of either on the main path
        dict(name="gn", route="cuda",
             source="mast3r_slam_torch/csrc/gn.cu",
             replaces="mast3r_slam_tpu/ops/gn_pallas.py:40",
             launches=launches["gn_accumulate"] + launches["gn_solve"],
             entry_launches={"gn_accumulate": launches["gn_accumulate"],
                             "gn_solve": launches["gn_solve"]}, **gnt),
        dict(name="gn_solve", route="cuda",
             source="mast3r_slam_torch/csrc/gn.cu",
             replaces="mast3r_slam_tpu/tracker.py:343",
             launches=launches["gn_solve"],
             launches_by_drive=by_drive["gn_solve"],
             gn_iterations=gn_iterations, **gnst),
        dict(name="pack_rows", route="cuda",
             source="mast3r_slam_torch/csrc/pack.cu",
             replaces="mast3r_slam_tpu/ops/pack.py:73",
             launches=launches["pack_rows"],
             launches_by_drive=by_drive["pack_rows"], **packt),
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the main path was not launched by it")
    print(f"attention decoder shape: {json.dumps(attn['decoder'])}")
    print(f"stages: {json.dumps(stages)}")
    print(f"stages reference-exact: {json.dumps(stages_exact)}")
    print(f"retrieval: {json.dumps(retrieval)}")
    print(f"int8: {json.dumps(int8)}")
    print(f"oracle ATE (m): {json.dumps(ate)}")
    print(f"tensor parallel: {json.dumps(tp)}")
    print(f"multi-GPU: {json.dumps(multi)}")
    print(f"viewer: {json.dumps(viewer)}")
    print(f"state: {json.dumps(state)}")
    print(f"checkpoint: {json.dumps(checkpoint)}")
    print(f"CLI drive: {json.dumps(cli)}")
    print(f"eval tools: {json.dumps(tools)}")
    print(f"bench_torch: {json.dumps(bench['record'])}")
    print(f"bench_torch stages: {json.dumps(bench['stages'])}")
    print(f"production drive, threaded, run 2, launches: "
          f"{json.dumps(launches_again)}")
    print(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
