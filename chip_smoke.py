#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``mast3r_slam_torch/csrc`` (attention
on the tensor cores, the GN accumulation and the whole GN solve in one
launch, the probe-table pack), holds each against its plain PyTorch version
on the card at the shapes the main path gives it, and times it beside its
bound, its plain version and (where one exists) a single PyTorch library
call.  Then it drives the port as a user would:

* ``main_torch.run`` (the frame loop of ``main_torch.py``) at full ViT-L
  width on 384x512 frames with seeded random weights and ``config/base.yaml``
  unmodified (the production matcher), counting that every attention, GN
  solve and table pack of that drive went through the kernels, and writing
  and reading back the trajectory;
* a short drive at the same width with ``reference_exact: true`` (the
  full-resolution matcher and the per-component Huber solve);
* the oracle harness (a rendered 16-frame clip with known poses),
  uncalibrated and calibrated, scored by ATE;
* a stage breakdown of one tracking step.

Run from the repository root:  python3 chip_smoke.py [--seed N]
Exits non-zero, printing no result, when any phase fails or no CUDA card is
present.  The last line is the JSON device record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# Dense data-sheet peaks (bf16 tensor-core FLOP/s, device-memory bytes/s)
# of the card the port runs on, by the name the driver reports.
_PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}

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
# the drive's clip: frames, pixels between consecutive frames, and the share
# of blurred noise in its image (testing.make_clip)
N_FRAMES, CLIP_SHIFT, CLIP_TEXTURE = 6, 32, 0.5
N_FRAMES_REFERENCE_EXACT = 3
# ATE limits of the oracle drives: those of tests/test_pipeline.py
ORACLE_ATE_LIMIT = {"uncalibrated": 0.05, "calibrated": 0.1}


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


def check_pack(match_cfg, peak_bw, card):
    """Kernel C against ``pack_rows_plain``, bitwise (it is a copy): every
    table of the production matcher at 384x512 in int8, f16, bf16 and f32,
    a batch of 2, a table no tile divides (300 x 7 rows) and offsets beyond
    the table.  Then the time of each production table in its own dtype
    beside the plain version, the single advanced-index gather that
    computes the same table from a zero-padded copy, and the bound."""
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
    for label, _, fdim, offs, row0, n_rows in tables:
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

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for label, dt, fdim, offs, row0, n_rows in tables:
        hw = n_rows + 2 * row0
        x = table(dt, 1, hw, fdim)
        lo = min(0, row0 + min(offs))
        hi = max(hw, row0 + n_rows + max(offs))
        padded = F.pad(x, (0, 0, -lo, hi - hw))
        index = (torch.arange(n_rows, device="cuda")[:, None] + (row0 - lo)
                 + torch.tensor(offs, device="cuda")[None, :])
        lib = padded[:, index].reshape(1, n_rows, -1)
        if not torch.equal(lib, pack.pack_rows(x, offs, row0, n_rows)):
            raise SystemExit("the library gather computes another table")
        del lib
        nbytes = x.element_size() * fdim * (hw + n_rows * len(offs))
        t = {
            "ms": time_ms(lambda: pack.pack_rows(x, offs, row0, n_rows),
                          reps=100),
            "plain_ms": time_ms(
                lambda: pack.pack_rows_plain(x, offs, row0, n_rows), reps=20),
            "library_ms": time_ms(lambda: padded[:, index], reps=20),
            "bound_ms": nbytes / peak_bw * 1e3,
        }
        print(f"pack {label} ({hw}, {fdim}) {dt} K={len(offs)} -> "
              f"{n_rows} x {len(offs) * fdim * x.element_size()} B: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, gather "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"(bytes) [{card}]")
        for key in total:
            total[key] += t[key]
    print(f"pack, the {len(tables)} tables of one match: kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, gather "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms "
          f"[{card}]")
    total.update(bound_by="bytes", max_abs_err=0.0)
    return total


def check_small_model():
    """The network through the kernels on the card against the same weights
    through the plain versions on the CPU, at a small f32 size whose
    attention heads have Dh = 64."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    cfg = MASt3RConfig.tiny(enc_embed_dim=128, enc_num_heads=2,
                            dec_embed_dim=128, dec_num_heads=2)
    torch.manual_seed(1)
    state = MASt3R(cfg).state_dict()
    hw = (64, 96)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, hw[0], hw[1], 3)).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        model = MASt3R(cfg)
        model.load_state_dict(state)
        eng = InferenceEngine(model, hw, device=dev)
        feat, pos = eng.encode(img.to(dev))
        out1, out2 = eng.decode_pair(feat, pos, feat, pos)
        res[dev] = [t.float().cpu() for t in (feat, *out1, *out2)]
    names = ["feat", "X1", "C1", "D1", "Q1", "X2", "C2", "D2", "Q2"]
    for name, a, b in zip(names, res["cpu"], res["cuda"]):
        err = (a - b).abs().max().item()
        tol = 1e-3 * (1.0 + a.abs().max().item())
        print(f"small model {name}: card vs CPU max abs err {err:.3e} "
              f"(tol {tol:.1e})")
        if not err <= tol:
            raise SystemExit("the network on the card disagrees with the "
                             "CPU reference")


def build_engine(seed):
    """The ViT-L network with the weights of ``torch.manual_seed(seed)``,
    conditioned so that the clip tracks
    (``testing.condition_for_tracking``), in an engine on the card."""
    import torch

    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
    from mast3r_slam_torch.testing import condition_for_tracking

    mcfg = MASt3RConfig.vit_large()
    torch.manual_seed(seed)
    model = MASt3R(mcfg)
    model.load_state_dict(condition_for_tracking(
        model.state_dict(), mcfg.patch_size, mcfg.local_feat_dim))
    return InferenceEngine(model, IMG_HW, device="cuda"), mcfg


def drive_frontend(engine, mcfg, cfg, frames, card, label):
    """``main_torch.run`` (dataset -> ``SLAMSystem.process_frame`` ->
    summary) over an in-memory clip with the configuration ``cfg``, then the
    trajectory written with ``evaluate.save_traj`` and read back.  Every
    kernel's count is set to 0 just before the loop and read just after;
    the counts must be what the configuration implies."""
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
    system = SLAMSystem(cfg, engine, IMG_HW, buffer=len(frames),
                        device="cuda")
    dataset = ClipDataset(frames)
    args = main_torch.parse_args(["--no-viz"])
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

    stats = summary["stats"]
    n = summary["frames"]
    print(f"{label}: {n} frames in {wall_ms:.1f} ms, stats {stats}, mean GN "
          f"iterations {summary['mean_gn_iters']:.2f} [{card}]")
    if summary["lost_at"] is not None or n != len(frames) or \
            stats["skipped"]:
        raise SystemExit(f"{label}: the drive lost tracking (random "
                         f"weights); relocalization is a later slice")
    tracked = stats["tracked"]
    if tracked != n - 1:
        raise SystemExit(f"{label}: {tracked} tracked frames of {n - 1}")

    # every frame encodes once and decodes once (INIT: mono decode;
    # TRACKING: asymmetric decode), each decode with 4 attentions a block
    expect_attn = (mcfg.enc_depth + 4 * mcfg.dec_depth) * n
    per_match = len(pack_tables(engine.match_cfg, IMG_HW))
    expect_pack = per_match * tracked
    joint = TrackerConfig.from_config(cfg).joint_ray_huber
    print(f"{label}: attention launches {launches['attention']} (expected "
          f"{expect_attn} = ({mcfg.enc_depth} + {4 * mcfg.dec_depth}) x {n} "
          f"frames); pack launches {launches['pack_rows']} (expected "
          f"{expect_pack} = {per_match} tables x {tracked} tracked frames); "
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
    }
    for name, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"non-finite {name}")
    if tuple(system.arena.X.shape[1:]) != (IMG_HW[0] * IMG_HW[1], 3):
        raise SystemExit("unexpected pointmap shape")
    with tempfile.TemporaryDirectory() as tmp:
        evaluate.save_traj(tmp, "traj.txt", dataset.timestamps, system.arena)
        ts, pos, quat = evaluate.load_tum_trajectory(f"{tmp}/traj.txt")
    if len(ts) != n_kf or not np.allclose(
            pos, system.arena.T_WC[:n_kf, :3].cpu().numpy(), rtol=1e-5,
            atol=1e-6) or not np.allclose(np.linalg.norm(quat, axis=-1), 1.0,
                                          atol=1e-5):
        raise SystemExit(f"{label}: the trajectory file does not hold the "
                         f"keyframe poses")
    print(f"{label}: {n_kf} keyframes, all outputs finite, trajectory "
          f"written and read back")
    return launches, system


def drive_oracle(card):
    """The oracle harness on the card: the 16-frame 48x64 clip of
    ``tests/test_pipeline.py`` rendered with known poses, ``OracleEngine``
    in place of the network, the frontend uncalibrated and calibrated, and
    the trajectory scored by ATE against the ground truth."""
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
        cfg = load_config(path)
        cfg["dataset"]["img_size"] = 64
        engine = OracleEngine(seq, device="cuda")
        system = SLAMSystem(cfg, engine, (seq.h, seq.w),
                            K=seq.K if cfg["use_calib"] else None, buffer=32,
                            device="cuda")
        gn.gn_solve.launches = 0
        for i in range(len(seq)):
            system.process_frame(i, seq.images[i])
        system.terminate()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            evaluate.save_traj(tmp, "est.txt", seq.timestamps, system.arena)
            seq.write_gt(f"{tmp}/gt.txt")
            ate = evaluate.ate_rmse(f"{tmp}/gt.txt", f"{tmp}/est.txt",
                                    max_diff=0.05)
        print(f"oracle drive {mode}: ATE RMSE {ate:.6f} m (limit "
              f"{ORACLE_ATE_LIMIT[mode]} m), stats {system.stats}, gn_solve "
              f"launches {gn.gn_solve.launches} [{card}]")
        if system.stats["skipped"] or system.stats["keyframes"] < 2 or \
                not ate < ORACLE_ATE_LIMIT[mode]:
            raise SystemExit(f"oracle drive {mode} failed")
        out[mode] = ate
    return out


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
        out["device_busy_ms"] = device_busy(step)
        out["idle_share"] = 1.0 - out["device_busy_ms"] / out["track_step"]
        print(f"{label} track_step: device busy "
              f"{out['device_busy_ms']:.3f} ms of {out['track_step']:.3f} "
              f"ms, idle share {out['idle_share']:.3f} [{card}]")
    return out


def device_busy(fn, top=12):
    """Sum of the device kernels' times in one traced call of ``fn``
    (``torch.profiler``), printing the ``top`` kernels by time.  Kernels of
    one stream do not overlap, so the sum is the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        raise SystemExit("the profiler saw no device time")
    for ms, n, key in rows[:top]:
        print(f"  kernel {ms:8.3f} ms {n:5d}x {key[:90]}")
    return sum(r[0] for r in rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.testing import make_clip
    from mast3r_slam_torch.tracker import TrackerConfig
    from mast3r_slam_torch.utils.config import (apply_reference_exact,
                                                load_config)

    cfg = load_config("config/base.yaml")       # as written
    cfg_exact = apply_reference_exact(cfg)

    attn = check_attention(peak_flops, peak_bw, card)
    gnt = check_gn(peak_bw, card)
    gnst = check_gn_solve(TrackerConfig.from_config(cfg), peak_bw, card)
    packt = check_pack(MatchingConfig.from_dict(cfg["matching"]), peak_bw,
                       card)
    check_small_model()

    engine, mcfg = build_engine(args.seed)
    frames = make_clip(args.seed, N_FRAMES + 1, IMG_HW, CLIP_SHIFT,
                       CLIP_TEXTURE)
    launches, system = drive_frontend(engine, mcfg, cfg, frames[:N_FRAMES],
                                      card, "production drive")
    stages = breakdown(system, frames[-1], card, "production")
    del system
    _, system_exact = drive_frontend(
        engine, mcfg, cfg_exact, frames[:N_FRAMES_REFERENCE_EXACT], card,
        "reference-exact drive")
    stages_exact = breakdown(system_exact,
                             frames[N_FRAMES_REFERENCE_EXACT], card,
                             "reference-exact", full=False)
    del system_exact
    ate = drive_oracle(card)

    kernels = [
        dict(name="attention", route="cuda",
             source="mast3r_slam_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:28",
             launches=launches["attention"], tensor_core_sass=tc_ops,
             **attn["encoder"]),
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
             gn_iterations=launches["gn_iterations"], **gnst),
        dict(name="pack_rows", route="cuda",
             source="mast3r_slam_torch/csrc/pack.cu",
             replaces="mast3r_slam_tpu/ops/pack.py:73",
             launches=launches["pack_rows"], **packt),
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the main path was not launched by it")
    print(f"attention decoder shape: {json.dumps(attn['decoder'])}")
    print(f"stages: {json.dumps(stages)}")
    print(f"stages reference-exact: {json.dumps(stages_exact)}")
    print(f"oracle ATE (m): {json.dumps(ate)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
