"""Per-block network timing breakdown (``--profile-blocks``).

Mirrors ``mast3r_slam_tpu/utils/breakdown.py``: the reference's
PatchEmbed / Encoder_attn / Encoder_mlp / Decoder_attn /
Decoder_cross_attn / Decoder_mlp summary.  Each sub-block of the port's own
model is timed as its own call on the model's device, and the per-frame
totals are synthesised from the model's static call counts: ``enc_depth``
encoder blocks a frame, ``2 x dec_depth`` decoder blocks a two-view decode.
On the card a call's time is CUDA events around ``n_chain`` calls after a
warm-up (a sub-block whose kernels are shorter than their launches reads
at the host's pace, as it does inside a frame); on the CPU, the host clock.
"""

from __future__ import annotations

import time

import torch


def _seconds_per_call(fn, n_chain, device):
    """Mean seconds of one ``fn()`` over ``n_chain`` calls after one
    warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_chain):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / n_chain
    t0 = time.perf_counter()
    for _ in range(n_chain):
        fn()
    return (time.perf_counter() - t0) / n_chain


@torch.no_grad()
def network_breakdown(model, img_hw, n_chain: int = 8) -> dict:
    """Per-sub-block latency of ``model`` (the port's ``MASt3R``) at
    ``img_hw``, synthesised to seconds per tracked frame (breakdown.py:44).
    Returns {section: seconds} for the reference taxonomy's keys."""
    cfg = model.cfg
    device = next(model.parameters()).device
    h, w = img_hw
    p = cfg.patch_size
    N = (h // p) * (w // p)
    E, D = cfg.enc_embed_dim, cfg.dec_embed_dim
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    yy, xx = torch.meshgrid(torch.arange(h // p, device=device),
                            torch.arange(w // p, device=device),
                            indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, N, 2)
    img, xe, xd = normal(1, h, w, 3), normal(1, N, E), normal(1, N, D)
    enc, dec = model.enc_blocks[0], model.dec_blocks[0]

    def per_call(fn):
        return _seconds_per_call(fn, n_chain, device)

    res = {"PatchEmbed": per_call(lambda: model.patch_embed(img))}
    res["Encoder_attn"] = per_call(lambda: enc.attn(xe, pos)) * cfg.enc_depth
    res["Encoder_mlp"] = per_call(lambda: enc.mlp(xe)) * cfg.enc_depth
    # a tracked frame decodes TWO views through dec_depth blocks each
    # (mast3r_utils.py:60-66 decoder(): dec_blocks + dec_blocks2)
    res["Decoder_attn"] = per_call(lambda: dec.attn(xd, pos)) \
        * cfg.dec_depth * 2
    res["Decoder_cross_attn"] = per_call(
        lambda: dec.cross_attn(xd, xd, xd, pos, pos)) * cfg.dec_depth * 2
    res["Decoder_mlp"] = per_call(lambda: dec.mlp(xd)) * cfg.dec_depth * 2
    return res


def print_network_summary(res: dict, extra: dict | None = None):
    """Reference-style report (profiler.py:37-110 shape): per-component
    table, encoder-vs-decoder split, internal attn/MLP breakdowns
    (breakdown.py:115, as it is)."""
    t_patch = res.get("PatchEmbed", 0.0)
    t_ea, t_em = res.get("Encoder_attn", 0.0), res.get("Encoder_mlp", 0.0)
    t_da = res.get("Decoder_attn", 0.0)
    t_dc = res.get("Decoder_cross_attn", 0.0)
    t_dm = res.get("Decoder_mlp", 0.0)
    t_enc, t_dec = t_ea + t_em, t_da + t_dc + t_dm
    vit = t_patch + t_enc + t_dec

    print("\n" + "=" * 50)
    print("NETWORK TIMING BREAKDOWN (per tracked frame)")
    print("=" * 50)
    print(f"ViT total: {vit * 1e3:.2f} ms")
    for k in ("PatchEmbed", "Encoder_attn", "Encoder_mlp", "Decoder_attn",
              "Decoder_cross_attn", "Decoder_mlp"):
        if k in res:
            print(f"  - {k}: {res[k] * 1e3:.2f} ms")
    eps = 1e-12
    print("\nEncoder vs Decoder:")
    print(f"  - Encoder: {t_enc * 1e3:.2f} ms "
          f"({100 * t_enc / max(t_enc + t_dec, eps):.1f}%)")
    print(f"  - Decoder: {t_dec * 1e3:.2f} ms "
          f"({100 * t_dec / max(t_enc + t_dec, eps):.1f}%)")
    print("\nEncoder internal:")
    print(f"  - Attention: {t_ea * 1e3:.2f} ms "
          f"({100 * t_ea / max(t_enc, eps):.1f}%)")
    print(f"  - MLP: {t_em * 1e3:.2f} ms ({100 * t_em / max(t_enc, eps):.1f}%)")
    print("\nDecoder internal:")
    print(f"  - Self-Attn: {t_da * 1e3:.2f} ms "
          f"({100 * t_da / max(t_dec, eps):.1f}%)")
    print(f"  - Cross-Attn: {t_dc * 1e3:.2f} ms "
          f"({100 * t_dc / max(t_dec, eps):.1f}%)")
    print(f"  - MLP: {t_dm * 1e3:.2f} ms ({100 * t_dm / max(t_dec, eps):.1f}%)")
    if extra:
        print()
        for k, v in extra.items():
            print(f"{k}: {v}")
    print("=" * 50 + "\n")
