"""The ported frontend against the JAX frontend on one 6-frame clip.

Both sides run the same tiny network (seeded torch init ->
``condition_for_tracking`` -> Flax params through the JAX package's own
checkpoint converter) on the same 64x96 frames, once with
``config/base.yaml``'s tracking block at the reference-exact matcher and
once with ``config/base.yaml`` as written (the production matcher; the
``test_production_*`` tests, whose docstrings state their tolerances).  The JAX side is the frontend loop of ``pipeline.py:360-433`` written out from
its ``InferenceEngine``, ``FrameTracker`` and ``update_pointmap``, without
the backend.

Tolerances: modes and keyframe decisions must be equal.  With each side's
own matcher, match fractions agree to 2e-3 and poses to atol 3e-3, not
tighter: ~0.1% of the pixels get a neighbouring match on one side (7 of
6,144 on the first tracked frame, on identical inputs).  The likely cause
is that the JAX ``iter_proj`` is always compiled, XLA:CPU contracts
``a*b + c`` into fused multiply-adds and PyTorch's CPU kernels do not, and
the per-pixel LM steps (divided by a near-singular 2x2 determinant)
amplify those last-bit differences until a match truncates to a
neighbour.  That moves the first tracked pose by ~4e-4, and the chained
frames carry it on: the largest difference over this clip is 1.8e-3.
A second port run takes the JAX matcher's ``idx_f2k`` and validity on
every tracked frame in place of its own; everything else (network, fusion,
GN solve, keyframe decisions) is the port's, and there the poses agree to
atol 1e-4, so the looser figure is the matcher's flips and nothing else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import frame as jfr
from mast3r_slam_tpu.inference import InferenceEngine as JaxEngine
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.ops import lie_sim3 as jsim3
from mast3r_slam_tpu.ops import matching as jmatch
from mast3r_slam_tpu.tracker import FrameTracker as JaxTracker
from mast3r_slam_tpu.tracker import TrackerConfig as JaxTrackerConfig
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
from mast3r_slam_torch.ops.matching import MatchingConfig
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.testing import condition_for_tracking, make_clip
from mast3r_slam_torch.utils.config import (REFERENCE_EXACT_OVERRIDES,
                                            load_config, merge_config)

H, W = 64, 96
N_FRAMES = 6
POSE_ATOL = 3e-3
FRAC_ATOL = 2e-3
SHARED_POSE_ATOL = 1e-4
# at the production matcher (see test_production_frontend_poses_match)
PROD_POSE_ATOL = 1e-2
PROD_FRAC_ATOL = 3e-3
PROD_SHARED_POSE_ATOL = 2e-4


def _run_jax(params, cfg, frames, head_dtype=jnp.float32):
    model = JaxMASt3R(JaxConfig.tiny(head_dtype=head_dtype))
    engine = JaxEngine(model, params, (H, W),
                       match_cfg=jmatch.MatchingConfig.from_dict(
                           cfg["matching"]))
    tracker = JaxTracker(engine, JaxTrackerConfig.from_config(cfg))
    fmode = jfr.FilteringMode.from_str(cfg["tracking"]["filtering_mode"])
    arena = jfr.make_arena(N_FRAMES, H, W, engine.n_patches, engine.feat_dim)
    mode, last_T, log = jfr.Mode.INIT, jsim3.identity(), []
    for i, img in enumerate(frames):
        if mode == jfr.Mode.RELOC:
            break
        normed = img.astype(np.float32) * (1.0 / 127.5) - 1.0
        feat, pos = engine.encode(jnp.asarray(normed)[None])
        fr = jfr.Frame(
            frame_id=jnp.asarray(i, jnp.int32), uimg=jnp.asarray(img),
            T_WC=last_T, X_canon=jnp.zeros((H * W, 3)),
            C=jnp.zeros((H * W, 1)), feat=feat[0],
            pos=pos[0].astype(jnp.int32), N=jnp.zeros((), jnp.int32),
            N_updates=jnp.zeros((), jnp.int32), score=jnp.zeros(()))
        info = {"mode": mode.name, "new_kf": False}
        if mode == jfr.Mode.INIT:
            X, C = engine.inference_mono(fr.feat[None], fr.pos[None])
            fr = jfr.update_pointmap(fr, X[0], C[0], fmode, True)
            arena = jfr.arena_append(arena, fr)
            mode, last_T = jfr.Mode.TRACKING, fr.T_WC
        else:
            last = int(arena.n_size) - 1
            kf = jfr.arena_get(arena, last)
            new_kf, fr, kf, try_reloc, reuse = tracker.track(fr, kf)
            info["match_frac"] = tracker.last_diag["match_frac"]
            if reuse is not None:
                info["match"] = (np.array(reuse[0]), np.array(reuse[1]))
            if try_reloc:
                mode = jfr.Mode.RELOC
                info["mode"] = "TRACKING->RELOC"
            else:
                arena = jfr.arena_set(arena, last, kf)
                last_T = fr.T_WC
                if new_kf:
                    arena = jfr.arena_append(arena, fr)
                    info["new_kf"] = True
        info["T_WC"] = np.asarray(last_T)
        log.append(info)
    return log, np.asarray(arena.T_WC[:int(arena.n_size)])


def _run_port(sd, cfg, frames, matches=None, head_dtype=torch.float32):
    """The port's frontend; with ``matches`` (one (idx_f2k, valid) pair per
    tracked frame) the matcher's idx_f2k and validity are replaced by
    those."""
    model = MASt3R(MASt3RConfig.tiny(head_dtype=head_dtype))
    model.load_state_dict(sd)
    engine = InferenceEngine(model, (H, W),
                             match_cfg=MatchingConfig.from_dict(
                                 cfg["matching"]), device="cpu")
    if matches is not None:
        own, given = engine.match_asymmetric, iter(matches)

        def shared(*args):
            idx, valid, *rest = own(*args)
            idx_j, valid_j = next(given)
            return (torch.from_numpy(idx_j).to(idx.dtype),
                    torch.from_numpy(valid_j).to(valid.dtype), *rest)

        engine.match_asymmetric = shared
    system = SLAMSystem(cfg, engine, (H, W), buffer=N_FRAMES, device="cpu")
    log = []
    for i, img in enumerate(frames):
        if system.mode.name == "RELOC":
            break
        info = system.process_frame(i, img)
        info["T_WC"] = system.last_T_WC.numpy()
        log.append(info)
    return log, system.arena.T_WC[:system.arena.n_size].numpy()


def _clip_inputs():
    """The conditioned tiny network (port state dict, Flax params) and the
    clip's frames."""
    torch.manual_seed(0)
    sd = condition_for_tracking(MASt3R(MASt3RConfig.tiny()).state_dict())
    jcfg = JaxConfig.tiny()
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    return sd, params, make_clip(0, N_FRAMES, (H, W), shift=4)


def _three_runs(cfg):
    sd, params, frames = _clip_inputs()
    jax_run = _run_jax(params, cfg, frames)
    matches = [s["match"] for s in jax_run[0] if "match" in s]
    return (jax_run, _run_port(sd, cfg, frames),
            _run_port(sd, cfg, frames, matches))


@pytest.fixture(scope="module")
def runs():
    """The production tracking block at the reference-exact matcher."""
    return _three_runs(merge_config(
        load_config("config/base.yaml"),
        {"matching": REFERENCE_EXACT_OVERRIDES["matching"]}))


@pytest.fixture(scope="module")
def production_runs():
    """``config/base.yaml`` as written."""
    cfg = load_config("config/base.yaml")
    assert cfg["matching"]["coarse_subsample"] == 2
    return _three_runs(cfg)


def test_frontend_tracks_the_clip(runs):
    """The clip is trackable, so the comparison covers TRACKING frames and
    keyframe decisions, not only INIT."""
    (jlog, _), (tlog, _), _ = runs
    assert len(tlog) == N_FRAMES
    assert all(s["mode"] == "TRACKING" for s in tlog[1:])
    assert any(s["new_kf"] for s in tlog)


def test_frontend_modes_and_keyframes_match(runs):
    (jlog, jkf), (tlog, tkf), _ = runs
    assert [s["mode"] for s in tlog] == [s["mode"] for s in jlog]
    assert [s["new_kf"] for s in tlog] == [s["new_kf"] for s in jlog]
    assert tkf.shape == jkf.shape


def test_frontend_poses_match(runs):
    (jlog, jkf), (tlog, tkf), _ = runs
    for js, ts in zip(jlog, tlog):
        np.testing.assert_allclose(ts["T_WC"], js["T_WC"], atol=POSE_ATOL,
                                   rtol=0)
        if "match_frac" in js:
            assert abs(ts["match_frac"] - js["match_frac"]) <= FRAC_ATOL
    np.testing.assert_allclose(tkf, jkf, atol=POSE_ATOL, rtol=0)


def test_frontend_poses_match_with_shared_matches(runs):
    """With the JAX matcher's matches the port agrees at atol 1e-4 (the
    largest difference over this clip is ~1.1e-5) and gates the same
    pixels."""
    (jlog, jkf), _, (slog, skf) = runs
    assert len(slog) == len(jlog) == N_FRAMES
    assert [s["mode"] for s in slog] == [s["mode"] for s in jlog]
    assert [s["new_kf"] for s in slog] == [s["new_kf"] for s in jlog]
    for js, ss in zip(jlog, slog):
        np.testing.assert_allclose(ss["T_WC"], js["T_WC"],
                                   atol=SHARED_POSE_ATOL, rtol=0)
        if "match_frac" in js:   # the same pixels pass the gates
            assert abs(ss["match_frac"] - js["match_frac"]) < 0.5 / (H * W)
    np.testing.assert_allclose(skf, jkf, atol=SHARED_POSE_ATOL, rtol=0)


def test_production_frontend_tracks_and_decides_like_jax(production_runs):
    """At the production matcher the clip tracks on every frame, and the
    port makes the JAX frontend's mode and keyframe decisions."""
    (jlog, jkf), (tlog, tkf), _ = production_runs
    assert len(tlog) == len(jlog) == N_FRAMES
    assert all(s["mode"] == "TRACKING" for s in tlog[1:])
    assert [s["mode"] for s in tlog] == [s["mode"] for s in jlog]
    assert [s["new_kf"] for s in tlog] == [s["new_kf"] for s in jlog]
    assert tkf.shape == jkf.shape


def test_production_frontend_poses_match(production_runs):
    """Each side's own production matcher: match fractions to 3e-3 and
    poses to atol 1e-2, looser than the reference-exact run's 2e-3 and
    3e-3.  The LM runs on the quarter grid and its positions are
    interpolated twice, so one LM position that truncates to the
    neighbouring pixel on one side moves 16 of the 6,144 pixels (measured:
    match fraction 0.4160 against 0.4186 on the two keyframe frames), and
    the radius-1 final pass does not pull them back; on this random-weight
    scene (poses with scale 0.17 and |t| 1.5 after five frames) that moves
    a pose by up to 8.6e-3."""
    (jlog, jkf), (tlog, tkf), _ = production_runs
    for js, ts in zip(jlog, tlog):
        np.testing.assert_allclose(ts["T_WC"], js["T_WC"],
                                   atol=PROD_POSE_ATOL, rtol=0)
        if "match_frac" in js:
            assert abs(ts["match_frac"] - js["match_frac"]) <= PROD_FRAC_ATOL
    np.testing.assert_allclose(tkf, jkf, atol=PROD_POSE_ATOL, rtol=0)


def test_production_frontend_poses_match_with_shared_matches(
        production_runs):
    """With the JAX production matcher's matches the port gates the same
    pixels and agrees at atol 2e-4 (measured 1.25e-4, against 1.1e-5 at the
    reference-exact matcher: the rougher radius-1 matches leave the GN
    system of this scene worse conditioned, so f32 summation order shows
    more)."""
    (jlog, jkf), _, (slog, skf) = production_runs
    assert [s["new_kf"] for s in slog] == [s["new_kf"] for s in jlog]
    for js, ss in zip(jlog, slog):
        np.testing.assert_allclose(ss["T_WC"], js["T_WC"],
                                   atol=PROD_SHARED_POSE_ATOL, rtol=0)
        if "match_frac" in js:
            assert abs(ss["match_frac"] - js["match_frac"]) < 0.5 / (H * W)
    np.testing.assert_allclose(skf, jkf, atol=PROD_SHARED_POSE_ATOL, rtol=0)
