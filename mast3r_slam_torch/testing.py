"""Fixtures for driving the frontend without a checkpoint or a dataset.

The role of ``mast3r_slam_tpu/testing.py``: no published weights or clips
are in the repository, so the tests and ``chip_smoke.py`` drive the real
network with seeded random weights on frames made with numpy, and drive the
whole system against a known trajectory with the synthetic-scene harness
(``SyntheticSequence`` + ``OracleEngine``, testing.py:25-420, rendered in
numpy with the poses as torch tensors), with the oracle's q8 world
descriptors for the descriptor paths (``export_desc``) and an ASMK
database over its view signatures (``make_oracle_retrieval``), and a
drain of the threaded backend that cannot hang (``drain_within``).
"""

from __future__ import annotations

import copy
import pathlib
import time

import numpy as np
import torch

from .device import resolve_device
from .ops import gn
from .ops import lie_sim3 as sim3
from .ops.geometry import get_pixel_coords

# kernel B's sums against its plain version, entry by entry (gn_sums_check)
GN_RTOL, GN_FLOOR = 1e-4, 1e-5
# the production drive's clip (chip_smoke.py's drives, bench_torch.py's
# drive_tracked_frame): frames, pixels between consecutive frames and the
# share of blurred noise in its image; with the conditioned ViT-L at
# 384x512 and config/base.yaml it makes two keyframes
PRODUCTION_CLIP = (6, 32, 0.5)


def make_clip(seed: int, n: int, hw, shift: int = 1,
              texture: float = 0.0) -> list[np.ndarray]:
    """``n`` uint8 (h, w, 3) frames cut from one image, each ``shift``
    pixels right of the last: red ramps left to right, green top to bottom,
    plus a ``texture`` share of blurred seeded noise."""
    from PIL import Image, ImageFilter

    h, w = hw
    H, W = h + 16, w + shift * n + 16
    rng = np.random.default_rng(seed)
    noise = Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8))
    noise = np.asarray(noise.filter(ImageFilter.GaussianBlur(2)), np.float64)
    noise = (noise - noise.min()) / max(np.ptp(noise), 1e-9)
    ramp = np.zeros((H, W, 3))
    ramp[..., 0] = np.linspace(0, 1, W)[None, :]
    ramp[..., 1] = np.linspace(0, 1, H)[:, None]
    img = (255 * (texture * noise + (1 - texture) * ramp)).astype(np.uint8)
    return [np.ascontiguousarray(img[8:8 + h, 8 + shift * i:8 + shift * i + w])
            for i in range(n)]


def production_clip(seed: int, hw) -> list[np.ndarray]:
    """The production drive's ``PRODUCTION_CLIP`` frames and one more, the
    frame after the drive's last (``make_clip``)."""
    n, shift, texture = PRODUCTION_CLIP
    return make_clip(seed, n + 1, hw, shift, texture)


def condition_for_tracking(sd: dict, patch_size: int = 16,
                           local_feat_dim: int = 24,
                           residual_scale: float = 0.02,
                           xyz_scale: float = 3.0,
                           desc_conf_bias: float = 2.0) -> dict:
    """A random-weight state dict reshaped so the frontend has something to
    track; returns a new dict.

    With raw random weights the pointmaps of two views share no geometry,
    no match passes the occlusion gate and the tracker drops to
    relocalization on its first frame.  Here the transformer's residual
    branches are scaled down (each block stays close to the identity), the
    second decoder branch and head are tied to the first (as the reference
    loader does for a checkpoint without ``dec_blocks2``), the pointmap head
    is biased to a surface in front of the camera whose shape follows the
    image (``xyz_scale``: a nearly flat, nearly constant pointmap leaves the
    7x7 Sim(3) system too ill-conditioned for its f32 solve), and the
    descriptor confidence is raised above the tracker's Q gate.
    """
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith(("enc_blocks.", "dec_blocks.")) and \
                k.endswith(("attn.proj.weight", "mlp.fc2.weight")):
            out[k] = v * residual_scale
    w = out["downstream_head1.dpt.head.4.weight"].clone()
    b = out["downstream_head1.dpt.head.4.bias"].clone()
    w[:3] *= xyz_scale
    b[:3] = b.new_tensor([0.0, 0.0, 1.0])
    out["downstream_head1.dpt.head.4.weight"] = w
    out["downstream_head1.dpt.head.4.bias"] = b
    key = "downstream_head1.head_local_features.fc2.bias"
    b = out[key].clone()
    pp = patch_size * patch_size
    b[local_feat_dim * pp:(local_feat_dim + 1) * pp] += desc_conf_bias
    out[key] = b
    for k in list(out):
        if k.startswith("dec_blocks."):
            out["dec_blocks2." + k[len("dec_blocks."):]] = out[k]
        elif k.startswith("downstream_head1."):
            out["downstream_head2." + k[len("downstream_head1."):]] = out[k]
    return out


def build_seeded_engine(mcfg, img_hw, seed: int = 0, device="cuda",
                        **engine_kw):
    """The network of ``mcfg`` with the weights of
    ``torch.manual_seed(seed)``, conditioned so that a clip tracks
    (``condition_for_tracking``), in an ``InferenceEngine`` at ``img_hw`` on
    ``device``; ``engine_kw`` go to the engine.  Returns the engine and the
    conditioned f32 state dict."""
    from .inference import InferenceEngine
    from .models.mast3r import MASt3R

    torch.manual_seed(seed)
    model = MASt3R(mcfg)
    sd = condition_for_tracking(model.state_dict(), mcfg.patch_size,
                                mcfg.local_feat_dim)
    model.load_state_dict(sd)
    return InferenceEngine(model, img_hw, device=device, **engine_kw), sd


def gn_problem(n: int, seed: int, device="cpu"):
    """One GN iteration's inputs at a pose far from the identity: keyframe
    points Xk, frame points Xf = T_true^-1 Xk with noise and 10% gross
    outliers, a 90% validity mask, and the pose T = exp(delta) o T_true
    (rotation ~0.2 rad, translation ~0.2, scale e^0.3) at which to evaluate.
    Returns (``gn.GNPointData``, T) on ``device``."""
    rng = np.random.default_rng(seed)
    Xk = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    Xk[:, 2] += 3.0
    xi = (rng.standard_normal(7) * 0.2).astype(np.float32)
    xi[6] = 0.3
    T_true = sim3.exp(torch.from_numpy(xi))
    Xk = torch.from_numpy(Xk)
    Xf = sim3.act(sim3.inv(T_true), Xk) + torch.from_numpy(
        rng.standard_normal((n, 3)).astype(np.float32) * 0.01)
    bad = torch.from_numpy(rng.random(n) < 0.1)
    Xf[bad] += 1.0
    vq = torch.from_numpy(((rng.random(n) < 0.9) * np.sqrt(
        rng.uniform(1.0, 4.0, n))).astype(np.float32))
    dk = torch.sqrt(torch.clamp((Xk * Xk).sum(-1), min=1e-24))
    rd_k_t = torch.cat([Xk.T / dk[None], dk[None]])
    T = sim3.retr(T_true, torch.from_numpy(
        (rng.standard_normal(7) * 0.01).astype(np.float32)))
    pre = gn.GNPointData(*(t.to(device) for t in (Xf, rd_k_t, vq / 0.003,
                                                  vq / 10.0)))
    return pre, T.to(device)


def gn_sums_check(sums, terms, rtol: float = GN_RTOL,
                  floor: float = GN_FLOOR):
    """Kernel B's 27 sums against the plain per-point terms (27, n) they
    should add up to, entry by entry: entry j passes when
    |sums_j - sum_i terms_ji| <= rtol |sum_i terms_ji| + floor sum_i |terms_ji|.
    The floor covers f32 rounding over n terms of either sign, so each entry
    is held to its own scale (H_ss and H_tt differ by five orders of
    magnitude).  Returns (err, tol), each (27,) on the host."""
    plain = terms.sum(dim=1)
    tol = rtol * plain.abs() + floor * terms.abs().sum(dim=1)
    return (sums - plain).abs().cpu(), tol.cpu()


# ---------------------------------------------------------------------------
# Synthetic scene: renderer, clip with ground truth, oracle engine
# ---------------------------------------------------------------------------

def surface_z(x, y, scene: str = "smooth"):
    """World surface height field (testing.py:25): ``smooth``, or ``cliff``
    with a ~1.2 m step along a curved line."""
    z = 4.0 + 0.6 * np.sin(1.3 * x) * np.cos(1.1 * y)
    if scene == "cliff":
        z = z - 1.2 * (np.sin(0.9 * x + 0.7 * y) > 0.2)
    return z


# floating occluder slab (scene "occluder"): plane z = OCC_Z over a disk
OCC_Z = 2.6
OCC_CENTER = (0.4, -0.3)
OCC_R = 0.9


def occluder_mask(x, y):
    cx, cy = OCC_CENTER
    return (x - cx) ** 2 + (y - cy) ** 2 < OCC_R ** 2


def texture(x, y, fg=False):
    """Smooth RGB texture on the surface, with a shifted palette on the
    occluder (testing.py:52)."""
    s = 2.4 if fg else 0.0
    r = 0.5 + 0.5 * np.sin(2.0 * x + s)
    g = 0.5 + 0.5 * np.cos(1.7 * y - s)
    b = 0.5 + 0.5 * np.sin(1.1 * (x + y) + s)
    return np.stack([r, g, b], axis=-1)


def make_K(h, w):
    return np.array(
        [[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]],
        dtype=np.float32)


def render_view(T_WC, h, w, K, scene: str = "smooth"):
    """Ray-march the surface from a camera pose (8,) (testing.py:69).
    Returns (rgb (h, w, 3) in [0, 1], X_cam (h*w, 3) pointmap in camera
    coordinates, X_world (h*w, 3)), all numpy f32."""
    Kinv = np.linalg.inv(K)
    uv = get_pixel_coords(1, (h, w)).reshape(-1, 2).numpy()
    dirs = (Kinv @ np.concatenate(
        [uv, np.ones((h * w, 1), np.float32)], axis=1).T).T
    T_t = torch.as_tensor(T_WC, dtype=torch.float32)
    T = T_t.numpy()
    t = T[:3]
    Rm = np.array([[float(e) for e in row]
                   for row in sim3.quat_rot_entries(T_t[3:7])], np.float32)
    d_w = (Rm @ dirs.T).T
    bg = "cliff" if scene == "cliff" else "smooth"
    lam = np.full(h * w, 3.0, np.float64)
    for _ in range(60):
        Xw = t[None] + lam[:, None] * d_w
        lam = lam + (surface_z(Xw[:, 0], Xw[:, 1], bg) - Xw[:, 2]) \
            / d_w[:, 2]
    Xw = (t[None] + lam[:, None] * d_w).astype(np.float32)
    rgb = texture(Xw[:, 0], Xw[:, 1]).reshape(-1, 3)
    if scene == "occluder":
        # ray/plane hit on the slab; takes precedence when closer
        with np.errstate(divide="ignore", invalid="ignore"):
            lam_fg = (OCC_Z - t[2]) / d_w[:, 2]
        Xf = t[None] + lam_fg[:, None] * d_w
        hit = (np.isfinite(lam_fg) & (lam_fg > 0.05) & (lam_fg < lam)
               & occluder_mask(Xf[:, 0], Xf[:, 1]))
        Xw = np.where(hit[:, None], Xf.astype(np.float32), Xw)
        rgb = np.where(hit[:, None], texture(Xf[:, 0], Xf[:, 1], fg=True),
                       rgb)
    Xc = sim3.act(sim3.inv(T_t), torch.from_numpy(Xw)).numpy()
    return rgb.reshape(h, w, 3).astype(np.float32), Xc, Xw


def world_descriptors(X_world, f: int = 24, base_wavelength: float = 0.35,
                      geometric: bool = False):
    """View-invariant, locally discriminative unit descriptors:
    multi-frequency positional encodings of the world surface coordinates
    (testing.py:108).  ``geometric`` uses an octave ladder over x, y and z
    whose longest period spans the scene, so the descriptors are globally
    unique."""
    x, y = X_world[:, 0], X_world[:, 1]
    feats = []
    if geometric:
        z = X_world[:, 2]
        n_oct = f // 6
        top = max(12.0, 32.0 * base_wavelength)
        ratio = (top / base_wavelength) ** (1.0 / max(n_oct - 1, 1))
        for k in range(n_oct):
            freq = 2 * np.pi / (base_wavelength * (ratio ** k))
            feats += [np.sin(freq * x), np.cos(freq * x),
                      np.sin(freq * y), np.cos(freq * y),
                      np.sin(freq * z), np.cos(freq * z)]
    else:
        n_oct = f // 4
        for k in range(n_oct):
            freq = 2 * np.pi / (base_wavelength * n_oct / (k + 1))
            feats += [np.sin(freq * x), np.cos(freq * x),
                      np.sin(freq * y), np.cos(freq * y)]
    D = np.stack(feats, axis=-1).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return D


def make_trajectory(n_frames: int, scale: float = 0.02, seed: int = 0,
                    loop: bool = False, cycles: int = 1):
    """Smooth bounded Sim(3) trajectory (n_frames, 8), first pose the
    identity (testing.py:159): a multi-frequency sinusoidal path whose
    per-frame motion stays ~``scale`` per dof.  ``loop`` closes the path;
    ``cycles`` sweeps the scene that many times at the same per-frame
    motion."""
    rng = np.random.default_rng(seed)
    amp = scale * n_frames / (2 * np.pi * max(cycles, 1))
    a = amp * np.array([1.0, 0.8, 0.6, 0.25, 0.25, 0.25, 0.08])
    phase = rng.uniform(0, 2 * np.pi, 7)
    freq = np.where(np.arange(7) % 2 == 0, 1.0, 2.0) * max(cycles, 1)
    if loop:
        freq = np.round(freq)  # integer cycles -> closed path
    ts = np.arange(n_frames) / max(n_frames - 1, 1)
    theta = 2 * np.pi * ts[:, None] * freq[None, :] + phase[None, :]
    xs = a[None, :] * (np.sin(theta) - np.sin(phase)[None, :])
    return sim3.exp(torch.from_numpy(xs.astype(np.float32)))


class SyntheticSequence:
    """Rendered clip with ground truth, presented like a dataset
    (testing.py:188).  ``save`` / ``load`` use the JAX package's ``.npz``
    layout, so either package reads a clip the other wrote."""

    def __init__(self, n_frames=20, h=48, w=64, seed=0, traj_scale=0.02,
                 loop=False, scene="smooth", cycles=1):
        self.h, self.w = h, w
        self.K = make_K(h, w)
        self.scene = scene
        self.T_WC = make_trajectory(n_frames, traj_scale, seed, loop, cycles)
        self.images, self.X_cam, self.X_world = [], [], []
        for i in range(n_frames):
            rgb, Xc, Xw = render_view(self.T_WC[i], h, w, self.K, scene)
            self.images.append(rgb)
            self.X_cam.append(Xc)
            self.X_world.append(Xw)
        self.timestamps = [float(i) / 30.0 for i in range(n_frames)]

    def __len__(self):
        return len(self.X_cam)

    def save(self, path):
        """The ground-truth geometry as one ``.npz``, from which
        ``OracleEngine`` can be driven."""
        np.savez_compressed(
            path,
            T_WC=self.T_WC.numpy(),
            X_cam=np.stack(self.X_cam),
            X_world=np.stack(self.X_world),
            K=self.K, h=self.h, w=self.w,
            timestamps=np.asarray(self.timestamps),
        )

    @classmethod
    def load(cls, path):
        d = np.load(path)
        obj = cls.__new__(cls)
        obj.h, obj.w = int(d["h"]), int(d["w"])
        obj.K = d["K"]
        obj.T_WC = torch.from_numpy(np.asarray(d["T_WC"], np.float32))
        obj.X_cam = list(d["X_cam"])
        obj.X_world = list(d["X_world"])
        obj.images = []
        obj.timestamps = list(d["timestamps"])
        return obj

    def write_gt(self, path):
        """TUM-format ground-truth trajectory."""
        T = self.T_WC.numpy()
        q = T[:, 3:7]
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        with open(path, "w") as f:
            for i in range(len(T)):
                x, y, z = T[i, :3]
                qx, qy, qz, qw = q[i]
                f.write(f"{self.timestamps[i]} {x} {y} {z} "
                        f"{qx} {qy} {qz} {qw}\n")


def write_clip(seq: SyntheticSequence, out_dir):
    """A rendered sequence as a clip folder that ``dataloader.load_dataset``
    and ``main_torch.py --oracle`` read: ``NNNNNN.png`` frames, ``gt.txt``
    (TUM format), ``oracle.npz`` and ``calibration.txt`` (fx fy cx cy), the
    layout of ``scripts/make_synthetic_clip.py``."""
    from PIL import Image

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(seq.images):
        Image.fromarray((img * 255).astype(np.uint8)).save(
            out / f"{i:06d}.png")
    seq.write_gt(out / "gt.txt")
    seq.save(out / "oracle.npz")
    K = seq.K
    np.savetxt(out / "calibration.txt",
               [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], fmt="%.6f")


class ClipDataset:
    """Frames held in memory, presented like a ``dataloader`` dataset:
    ``dataset[i] -> (timestamp, image)``, 30 frames a second."""

    def __init__(self, frames, name: str = "clip"):
        self.frames = list(frames)
        self.timestamps = [i / 30.0 for i in range(len(self.frames))]
        self.dataset_path = pathlib.Path(name)
        self.save_results = True

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.timestamps[idx], self.frames[idx]


class OracleEngine:
    """Stands in for ``InferenceEngine`` with decode outputs made from the
    synthetic ground truth (testing.py:249).

    Frame identity is carried through the ``feat`` tensor: feat[0, 0] holds
    the frame index.  ``noise_std`` perturbs the pointmaps to emulate
    network error.  Outputs are tensors on ``device``.
    """

    N_PATCHES = 16
    FEAT_DIM = 32

    def __init__(self, seq: SyntheticSequence, noise_std: float = 0.0,
                 match_noise_px: int = 0, seed: int = 0,
                 blackout_frames=(), export_desc: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.seq = seq
        self.h, self.w = seq.h, seq.w
        self.hw = self.h * self.w
        self.noise_std = noise_std
        self.match_noise_px = match_noise_px
        self.rng = np.random.default_rng(seed)
        self._encode_counter = 0
        self.img_hw = (self.h, self.w)
        self.n_patches = self.N_PATCHES
        self.feat_dim = self.FEAT_DIM
        # frames whose matches are wiped (tracking-failure injection)
        self.blackout_frames = set(blackout_frames)
        # export_desc: match_asymmetric also returns both views' q8 world
        # descriptors, which turns on the descriptor paths (the pose-warped
        # consecutive edge's tables, desc_global retrieval edges)
        self.export_desc = bool(export_desc)
        self._desc_cache: dict = {}

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def replica(self, device) -> "OracleEngine":
        """This oracle with its outputs on ``device`` (the backend device's
        engine, ``pipeline.SLAMSystem(backend_device=)``); it shares the
        clip, the frame counter's meaning and the noise stream, and is this
        oracle itself on its own device."""
        device = resolve_device(device)
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device = device
        twin._desc_cache = {}
        return twin

    def view_signature(self, i):
        """Content-based coarse view descriptor: subsampled world points."""
        Xw = self.seq.X_world[i]
        n = self.N_PATCHES * self.FEAT_DIM
        stride = max(1, (len(Xw) * 3) // n)
        flat = Xw.reshape(-1)[::stride][:n]
        sig = np.zeros(n, np.float32)
        sig[: len(flat)] = flat
        return sig.reshape(self.N_PATCHES, self.FEAT_DIM)

    def encode(self, img):
        i = self._encode_counter
        self._encode_counter += 1
        feat = self.view_signature(i).copy()
        feat[0, 0] = i  # frame identity channel, read by the oracle matcher
        return (self._t(feat[None]),
                torch.zeros((1, self.N_PATCHES, 2), dtype=torch.int64,
                            device=self.device))

    def _pointmap(self, i):
        X = self.seq.X_cam[i]
        if self.noise_std > 0:
            X = X + self.rng.normal(0, self.noise_std, X.shape) \
                .astype(np.float32)
        return X

    def _rel_pointmap(self, i, j):
        """Pointmap of camera j's pixels expressed in camera i's frame."""
        T_CiCj = sim3.rel(self.seq.T_WC[i], self.seq.T_WC[j])
        return sim3.act(T_CiCj, torch.from_numpy(self._pointmap(j))).numpy()

    def _match(self, i, j):
        """idx mapping camera-j pixels -> camera-i pixel indices through the
        true projection (with optional pixel noise), plus validity.  A
        projected point whose target pixel sees other geometry (an
        occlusion) is invalid, like the matcher's 3D-distance gate."""
        Xc_i = sim3.act(sim3.inv(self.seq.T_WC[i]),
                        torch.from_numpy(self.seq.X_world[j])).numpy()
        uvz = (self.seq.K @ Xc_i.T).T
        u = np.round(uvz[:, 0] / uvz[:, 2]).astype(np.int64)
        v = np.round(uvz[:, 1] / uvz[:, 2]).astype(np.int64)
        if self.match_noise_px:
            u += self.rng.integers(-self.match_noise_px,
                                   self.match_noise_px + 1, u.shape)
            v += self.rng.integers(-self.match_noise_px,
                                   self.match_noise_px + 1, v.shape)
        inside = (u >= 0) & (u < self.w) & (v >= 0) & (v < self.h) \
            & (Xc_i[:, 2] > 0)
        idx = np.where(inside, v * self.w + u, 0).astype(np.int64)
        seen = self.seq.X_world[i][idx]
        d3 = np.linalg.norm(seen - self.seq.X_world[j], axis=-1)
        pix = np.linalg.norm(self.seq.X_cam[i][idx], axis=-1) / max(
            float(self.seq.K[0, 0]), 1.0)  # ~1-pixel 3D footprint
        inside &= d3 < np.maximum(0.1, 3.0 * pix)
        return idx, inside

    @staticmethod
    def _fid(feat):
        return int(feat[0, 0, 0])

    def _desc8(self, i):
        """(1, hw, 24) int8 q8 world descriptors of view i, cached
        (testing.py:358): the globally unique geometric ladder, its finest
        period ~3 pixel footprints at the scene's depth."""
        if i not in self._desc_cache:
            footprint = 4.0 / float(self.seq.K[0, 0])
            D = world_descriptors(self.seq.X_world[i], geometric=True,
                                  base_wavelength=3.0 * footprint)
            self._desc_cache[i] = self._t(
                np.clip(np.round(D * 127.0), -127, 127).astype(np.int8)[None])
        return self._desc_cache[i]

    def match_asymmetric(self, frame_feat, frame_pos, kf_feat, kf_pos,
                         idx_i2j_init=None):
        fi = self._fid(frame_feat)
        ki = self._fid(kf_feat)
        Xff = self._pointmap(fi)
        Xkf = self._rel_pointmap(fi, ki)  # kf points in frame coordinates
        idx, inside = self._match(fi, ki)
        if fi in self.blackout_frames:
            inside = np.zeros_like(inside)
        ones = torch.ones((1, self.hw, 1), device=self.device)
        outs = (self._t(idx[None]), self._t(inside[None, :, None]),
                self._t(Xff[None]), 10.0 * ones, 4.0 * ones,
                self._t(Xkf[None]), 10.0 * ones, 4.0 * ones)
        if self.export_desc:
            outs = outs + (self._desc8(fi), self._desc8(ki))
        return outs

    def inference_mono(self, feat, pos):
        X = self._pointmap(self._fid(feat))
        return (self._t(X[None]),
                torch.full((1, self.hw, 1), 10.0, device=self.device))

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j):
        """Both directions of each edge from the true projection
        (testing.py:404), confidence 4 everywhere.  Like the JAX oracle it
        has no ``match_arrays_warp``: the backend completes a reused
        consecutive edge with ``match_asymmetric``."""
        B = feat_i.shape[0]
        idx_i2j = np.zeros((B, self.hw), np.int64)
        idx_j2i = np.zeros((B, self.hw), np.int64)
        vm_j = np.zeros((B, self.hw), bool)
        vm_i = np.zeros((B, self.hw), bool)
        for b in range(B):
            fi = self._fid(feat_i[b:b + 1])
            fj = self._fid(feat_j[b:b + 1])
            idx_i2j[b], vm_j[b] = self._match(fi, fj)
            idx_j2i[b], vm_i[b] = self._match(fj, fi)
        Q = torch.full((B, self.hw, 1), 4.0, device=self.device)
        return (self._t(idx_i2j), self._t(idx_j2i), self._t(vm_j[..., None]),
                self._t(vm_i[..., None]), Q, Q, Q, Q)


def make_oracle_retrieval(seq: SyntheticSequence, engine: OracleEngine,
                          codebook_size: int = 64, nfeat: int = 16):
    """A ``RetrievalDatabase`` over the oracle's view signatures
    (testing.py:423): ``RetrievalParams.random`` at the signature width and
    a k-means codebook of the sequence's own signatures, on the engine's
    device."""
    from .retrieval.asmk import Codebook
    from .retrieval.database import RetrievalDatabase
    from .retrieval.model import RetrievalParams

    d = engine.FEAT_DIM
    params = RetrievalParams.random(d_in=d, hdims=(d,))
    feats = np.concatenate(
        [engine.view_signature(i) for i in range(len(seq.X_world))])
    codebook = Codebook.train(feats, codebook_size, n_iter=5,
                              device=engine.device)
    return RetrievalDatabase(params, codebook, nfeat=nfeat)


def drain_within(system, seconds: float):
    """``system.drain()`` with a deadline: raises ``TimeoutError`` if the
    backend still has queued rounds after ``seconds`` (a stuck round would
    leave ``drain`` waiting for ever), else drains and re-raises the
    backend's error, if any."""
    end = time.monotonic() + seconds
    while system.tasks.unfinished_tasks:
        if time.monotonic() > end:
            raise TimeoutError(f"the backend still has "
                               f"{system.tasks.unfinished_tasks} rounds "
                               f"queued after {seconds} s")
        time.sleep(0.001)
    system.drain()
