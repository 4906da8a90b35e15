"""``dataset.img_downsample`` of the port's engine against the JAX engine.

Both sides run the conditioned tiny network of ``test_torch_frontend.py``
(f32 heads) on two 64x96 frames of its clip, with ``config/base.yaml``'s
matcher, each engine built with ``downsample=2``:

* ``decode_pair``'s (X, C, D, Q) of both views are (1, 32, 48, ...) and
  agree with JAX's at the network tests' tolerance (``test_torch_model.py``:
  atol 1e-4, of the largest magnitude beyond 1), and they are the
  ``downsample=1`` outputs strided by 2, bit for bit;
* ``match_asymmetric`` without an init starts from the identity of the
  32x48 grid: its index and validity cover 1,536 pixels; at least 99.5%
  of the validity flags equal JAX's (measured: all) and at least 97% of
  the indices (measured 98.1%, 29 pixels); its pointmaps and confidences
  within the tolerance above.  The index share is looser than
  ``test_torch_matching.py``'s 99.5% at full size for a reason of the
  matcher, not of the downsample: XLA:CPU fuses the LM's multiply-adds,
  which moves a few LM points, and at ``lm_subsample 4`` each of the 96 LM
  points of this grid seeds a 4x4 block of pixels.  The port's matcher fed
  JAX's own decode outputs gives the same 98.1% (99.6% at
  ``downsample=1`` on the same frames);
* the SLAM system: JAX's ``SLAMSystem`` takes a downsampled engine and
  fails at the first frame's fusion (its arena and frames are sized from
  ``img_hw``, the pointmaps from ``out_hw``); the port's refuses it at
  construction with a ``ValueError`` that says why.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.inference import InferenceEngine as JaxEngine
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.ops import matching as jmatch
from mast3r_slam_tpu.pipeline import SLAMSystem as JaxSLAMSystem
from mast3r_slam_torch.inference import InferenceEngine
from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
from mast3r_slam_torch.ops.matching import MatchingConfig
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.testing import condition_for_tracking, make_clip
from mast3r_slam_torch.utils.config import load_config

H, W, DS = 64, 96, 2
ATOL = 1e-4
IDX_AGREE, VALID_AGREE = 0.97, 0.995


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, port engine at downsample 1, config, the
    two frames normalised as (1, H, W, 3) f32)."""
    torch.manual_seed(0)
    sd = condition_for_tracking(MASt3R(MASt3RConfig.tiny()).state_dict())
    jcfg = JaxConfig.tiny()
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    cfg = load_config("config/base.yaml")
    jeng = JaxEngine(JaxMASt3R(jcfg), params, (H, W), downsample=DS,
                     match_cfg=jmatch.MatchingConfig.from_dict(
                         cfg["matching"]))
    model = MASt3R(MASt3RConfig.tiny())
    model.load_state_dict(sd)
    mcfg = MatchingConfig.from_dict(cfg["matching"])
    teng = InferenceEngine(model, (H, W), downsample=DS, match_cfg=mcfg,
                           device="cpu")
    teng1 = InferenceEngine(model, (H, W), match_cfg=mcfg, device="cpu")
    frames = [f.astype(np.float32)[None] * (1.0 / 127.5) - 1.0
              for f in make_clip(0, 2, (H, W), shift=4)]
    return jeng, teng, teng1, cfg, frames


def _close(t, j):
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=ATOL * max(1.0, np.abs(j).max()))


def _encode_both(jeng, teng, frames):
    jf = [jeng.encode(jnp.asarray(f)) for f in frames]
    tf = [teng.encode(torch.from_numpy(f)) for f in frames]
    return jf, tf


def test_downsampled_decode_matches_jax(engines):
    jeng, teng, teng1, _, frames = engines
    assert teng.out_hw == jeng.out_hw == (H // DS, W // DS)
    jf, tf = _encode_both(jeng, teng, frames)
    jres = jeng.decode_pair(*jf[0], *jf[1])
    tres = teng.decode_pair(*tf[0], *tf[1])
    full = teng1.decode_pair(*tf[0], *tf[1])
    for jv, tv, fv in zip(jres, tres, full):
        for j, t, f in zip(jv, tv, fv):
            assert tuple(t.shape[1:3]) == (H // DS, W // DS)
            _close(t, j)
            assert torch.equal(t, f[:, ::DS, ::DS])


def test_downsampled_match_asymmetric_matches_jax(engines):
    jeng, teng, _, _, frames = engines
    jf, tf = _encode_both(jeng, teng, frames)
    jout = jeng.match_asymmetric(*jf[1], *jf[0])
    tout = teng.match_asymmetric(*tf[1], *tf[0])
    n = (H // DS) * (W // DS)
    assert tuple(tout[0].shape) == (1, n)
    assert tuple(tout[1].shape) == (1, n, 1)
    idx_agree = float((tout[0].numpy() == np.asarray(jout[0])).mean())
    valid_agree = float((tout[1].numpy() == np.asarray(jout[1])).mean())
    print(f"downsample {DS}: idx equal {idx_agree:.4f}, valid equal "
          f"{valid_agree:.4f}, valid share {float(tout[1].float().mean()):.3f}")
    assert idx_agree >= IDX_AGREE and valid_agree >= VALID_AGREE
    assert bool(tout[1].any())
    for t, j in zip(tout[2:8], jout[2:8]):
        _close(t, j)


def test_system_takes_no_downsampled_engine(engines):
    """JAX's pipeline fails at the first fusion; the port says why at
    construction."""
    jeng, teng, _, cfg, frames = engines
    cfg = copy.deepcopy(cfg)
    cfg["single_thread"] = True
    img = make_clip(0, 1, (H, W), shift=4)[0]
    jsys = JaxSLAMSystem(cfg, jeng, (H, W), buffer=4)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jsys.process_frame(0, img)
    with pytest.raises(ValueError, match="img_downsample=2"):
        SLAMSystem(cfg, teng, (H, W), buffer=4, device="cpu")
