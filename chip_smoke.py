#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``mast3r_slam_torch/csrc``, holds each
against its plain PyTorch version on the card at the shapes the tracking
frontend gives it, times it beside its bound, its plain version and (where
one exists) a single PyTorch library call, then drives the frontend
(``SLAMSystem.process_frame``: INIT, then TRACKING) at full ViT-L width on
384x512 frames with seeded random weights, and counts that every attention
and every GN accumulation of that drive went through the kernels.

Run from the repository root:  python3 chip_smoke.py [--seed N]
Exits non-zero, printing no result, when any phase fails or no CUDA card is
present.  The last line is the JSON device record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
IMG_HW = (384, 512)
# the drive's clip: frames, pixels between consecutive frames, and the share
# of blurred noise in its image (testing.make_clip)
N_FRAMES, CLIP_SHIFT, CLIP_TEXTURE = 6, 32, 0.5


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
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_attention(peak_flops, peak_bw, card):
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import attention_plain, \
        flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for (B, H, Nq, Nk, Dh) in ATTN_SHAPES:
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = torch.randn(B, H, Nq, Dh, device="cuda", generator=gen).to(dt)
            k = torch.randn(B, H, Nk, Dh, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, H, Nk, Dh, device="cuda", generator=gen).to(dt)
            err = (flash_attention(q, k, v).float()
                   - attention_plain(q, k, v).float()).abs().max().item()
            torch.cuda.synchronize()
            ok = err <= ATTN_TOL[name]
            print(f"attention {name} B={B} H={H} Nq={Nq} Nk={Nk} Dh={Dh}: "
                  f"max abs err {err:.3e} (tol {ATTN_TOL[name]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("attention kernel disagrees with its plain "
                                 "version")
            worst[(B, H, Nq, Nk, name)] = err

    timings = {}
    for label, (B, H, Nq, Nk, Dh) in (("encoder", ATTN_SHAPES[0]),
                                      ("decoder", ATTN_SHAPES[1])):
        q, k, v = (torch.randn(B, H, n, Dh, device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (Nq, Nk, Nk))
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
        }
        timings[label] = t
        print(f"attention bf16 {label} (1,{H},{Nq},{Dh}): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}) [{card}]")
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


def drive_frontend(seed, card):
    """``SLAMSystem.process_frame`` over a clip at full ViT-L width, with the
    weights of ``torch.manual_seed(seed)`` conditioned so that the clip
    tracks (``testing.condition_for_tracking``)."""
    import torch

    from mast3r_slam_torch.frame import Mode
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
    from mast3r_slam_torch.ops import gn
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import condition_for_tracking, make_clip
    from mast3r_slam_torch.utils.config import frontend_config

    cfg = frontend_config("config/base.yaml")
    mcfg = MASt3RConfig.vit_large()
    torch.manual_seed(seed)
    model = MASt3R(mcfg)
    model.load_state_dict(condition_for_tracking(
        model.state_dict(), mcfg.patch_size, mcfg.local_feat_dim))
    engine = InferenceEngine(model, IMG_HW,
                             match_cfg=MatchingConfig.from_dict(
                                 cfg["matching"]), device="cuda")
    system = SLAMSystem(cfg, engine, IMG_HW, buffer=N_FRAMES, device="cuda")
    frames = make_clip(seed, N_FRAMES, IMG_HW, CLIP_SHIFT, CLIP_TEXTURE)
    torch.cuda.synchronize()

    flash_attention.launches = 0
    gn.gn_sums.launches = 0
    n_enc = n_dec = 0
    for i, img in enumerate(frames):
        if system.mode == Mode.RELOC:
            print(f"frame {i}: system is in RELOC (random weights); "
                  f"relocalization is a later slice, stopping the drive")
            break
        t0 = time.perf_counter()
        info = system.process_frame(i, img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_enc += 1
        n_dec += 1   # INIT: mono decode; TRACKING: asymmetric decode
        print(f"frame {i}: mode {info['mode']} match_frac "
              f"{info.get('match_frac', float('nan')):.4f} gn_iters "
              f"{info.get('gn_iters', 0)} kf_metric "
              f"{info.get('new_kf_metric', float('nan')):.4f} new_kf "
              f"{info['new_kf']} {ms:.1f} ms [{card}]")
    attn_launches = flash_attention.launches
    gn_launches = gn.gn_sums.launches

    expect = (mcfg.enc_depth * n_enc + 4 * mcfg.dec_depth * n_dec)
    print(f"attention launches {attn_launches} (expected {expect} = "
          f"{mcfg.enc_depth}x{n_enc} encodes + {4 * mcfg.dec_depth}x{n_dec} "
          f"decodes); GN launches {gn_launches}")
    if attn_launches != expect:
        raise SystemExit("attention launches do not match the drive")
    if gn_launches < 1:
        raise SystemExit("the GN kernel never ran in the drive")
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
    print(f"frontend: {n_enc} frames, {n_kf} keyframes, all outputs finite")
    return attn_launches, gn_launches, system


def breakdown(system, img, card):
    """Device time of each stage of one tracking step against the last
    keyframe, on the drive's own state: encode, decode + heads, dense
    match, the GN pose solve (inputs captured from a ``track_step``) and
    the whole ``track_step``.  Each figure is the mean of five back-to-back
    runs after one warm-up."""
    import torch

    from mast3r_slam_torch import tracker as trk
    from mast3r_slam_torch.frame import arena_get
    from mast3r_slam_torch.ops import matching

    eng = system.engine
    kf = arena_get(system.arena, system.arena.n_size - 1)
    frame = system.create_frame(0, img)
    hw = IMG_HW[0] * IMG_HW[1]
    idx0 = torch.arange(hw, device="cuda")[None]
    normed = torch.from_numpy(system.prepare_image(img)[0])[None].cuda()
    args = (frame.feat[None], frame.pos[None], kf.feat[None], kf.pos[None])
    (X1, _, D1, _), (X2, _, D2, _) = eng.decode_pair(*args)

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
    out = {
        "encode": time_ms(lambda: eng.encode(normed), reps=5, warmup=1),
        "decode_and_heads": time_ms(lambda: eng.decode_pair(*args), reps=5,
                                    warmup=1),
        "match": time_ms(lambda: matching.match(
            X1, X2, D1, D2, idx0, cfg=eng.match_cfg), reps=5, warmup=1),
        "gn_solve": time_ms(lambda: solve(*captured["args"]), reps=5,
                            warmup=1),
        "track_step": time_ms(lambda: trk.track_step(
            eng, frame, kf, idx0, system.tracker.cfg), reps=5, warmup=1),
    }
    for name, ms in out.items():
        note = f" ({iters} GN iterations)" if name == "gn_solve" else ""
        print(f"stage {name}: {ms:.3f} ms{note} [{card}]")
    out["gn_iters"] = iters
    out["device_busy_ms"] = device_busy(
        lambda: trk.track_step(eng, frame, kf, idx0, system.tracker.cfg))
    out["idle_share"] = 1.0 - out["device_busy_ms"] / out["track_step"]
    print(f"track_step: device busy {out['device_busy_ms']:.3f} ms of "
          f"{out['track_step']:.3f} ms, idle share {out['idle_share']:.3f} "
          f"[{card}]")
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
    logs = _build.build(["attention", "gn"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    attn = check_attention(peak_flops, peak_bw, card)
    gnt = check_gn(peak_bw, card)
    check_small_model()
    attn_launches, gn_launches, system = drive_frontend(args.seed, card)
    from mast3r_slam_torch.testing import make_clip

    stages = breakdown(system, make_clip(args.seed, N_FRAMES + 1, IMG_HW,
                                         CLIP_SHIFT, CLIP_TEXTURE)[-1], card)

    kernels = [
        dict(name="attention", route="cuda",
             source="mast3r_slam_torch/csrc/attention.cu",
             replaces="mast3r_slam_tpu/ops/attention.py:28",
             launches=attn_launches, **attn["encoder"]),
        dict(name="gn_accumulate", route="cuda",
             source="mast3r_slam_torch/csrc/gn.cu",
             replaces="mast3r_slam_tpu/ops/gn_pallas.py:40",
             launches=gn_launches, **gnt),
    ]
    print(f"attention decoder shape: {json.dumps(attn['decoder'])}")
    print(f"stages: {json.dumps(stages)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
