"""Dataset loaders and camera intrinsics handling.

Own copy of ``mast3r_slam_tpu/dataloader.py``: TUM-RGBD (per-freiburg
factory calibration), EuRoC (always undistorted), ETH3D, 7-Scenes, MP4
video, plain RGB folders, Realsense live and webcam (which need their
hardware and SDKs), plus the ``Intrinsics`` undistortion remap and the K
rescale to network resolution.  Host code in numpy and ``cv2``: image decode
and undistortion stay off the device, which sees only the resized normalised
frames.  ``cv2`` is imported where an image is read, never at import.

The JAX loader reads a process-global config; here every dataset takes the
config dict it was loaded for (``use_calib``, ``dataset.subsample``,
``dataset.center_principle_point``).
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import yaml

from .inference import resize_img


def _cv2():
    import cv2

    return cv2


def _imread_rgb(path):
    """An image file as (H, W, 3) uint8 RGB: through ``cv2`` where it is
    installed, else through PIL (PNG, which every supported dataset uses,
    decodes to the same pixels in both)."""
    try:
        cv2 = _cv2()
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


class MonocularDataset:
    """Base dataset (dataloader.py:20-64)."""

    def __init__(self, cfg: dict | None = None, dtype=np.float32):
        self.cfg = cfg or {}
        self.dtype = dtype
        self.rgb_files = []
        self.timestamps = []
        self.img_size = 512
        self.camera_intrinsics: Intrinsics | None = None
        self.use_calibration = bool(self.cfg.get("use_calib", False))
        self.save_results = True
        self.dataset_path: pathlib.Path | None = None

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        timestamp = self.get_timestamp(idx)
        return timestamp, img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx):
        return _imread_rgb(self.rgb_files[idx])

    def get_image(self, idx):
        """Returns the (optionally undistorted) frame as uint8 RGB.

        The reference converts to float here (dataloader.py:40-43); this
        framework defers the float conversion to the resize/normalize step
        (resize_img fuses it), saving two full-image float passes per
        frame on the host.  All consumers accept uint8 or float."""
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img

    def get_img_shape(self):
        img = self.read_img(0)
        raw_img_shape = img.shape
        out = resize_img(img, self.img_size)
        return out["img"][0].shape[:2], raw_img_shape[:2]

    def subsample(self, subsample: int):
        self.rgb_files = self.rgb_files[::subsample]
        self.timestamps = self.timestamps[::subsample]

    def has_calib(self):
        return self.camera_intrinsics is not None


class TUMDataset(MonocularDataset):
    """TUM-RGBD with the standard per-freiburg factory calibration
    (dataloader.py:67-89; the constants are the published TUM camera
    parameters)."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(
            self.dataset_path / "rgb.txt", delimiter=" ", dtype=str
        )
        self.rgb_files = [self.dataset_path / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])

        match = re.search(r"freiburg(\d+)", str(dataset_path))
        calib = None
        if match:
            idx = int(match.group(1))
            if idx == 1:
                calib = np.array([517.3, 516.5, 318.6, 255.3,
                                  0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
            elif idx == 2:
                calib = np.array([520.9, 521.0, 325.1, 249.7,
                                  0.2312, -0.7849, -0.0033, -0.0001, 0.9172])
            elif idx == 3:
                calib = np.array([535.4, 539.2, 320.1, 247.6])
        if calib is not None:
            self.camera_intrinsics = Intrinsics.from_calib(
                self.cfg, self.img_size, 640, 480, calib
            )


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0; fisheye distortion is always undistorted
    (dataloader.py:92-116)."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.use_calibration = True
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(
            self.dataset_path / "mav0/cam0/data.csv", delimiter=",",
            dtype=str,
        )
        self.rgb_files = [
            self.dataset_path / "mav0/cam0/data" / f for f in tstamp_rgb[:, 1]
        ]
        self.timestamps = list(tstamp_rgb[:, 0])
        with open(self.dataset_path / "mav0/cam0/sensor.yaml") as f:
            cam0 = yaml.safe_load(f)
        W, H = cam0["resolution"]
        intr = cam0["intrinsics"]
        dist = np.array(cam0["distortion_coefficients"])
        self.camera_intrinsics = Intrinsics.from_calib(
            self.cfg, self.img_size, W, H, [*intr, *dist],
            always_undistort=True
        )

    def read_img(self, idx):
        cv2 = _cv2()
        img = cv2.imread(str(self.rgb_files[idx]), cv2.IMREAD_GRAYSCALE)
        return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)


class ETH3DDataset(MonocularDataset):
    """dataloader.py:119-134."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(
            self.dataset_path / "rgb.txt", delimiter=" ", dtype=str
        )
        self.rgb_files = [self.dataset_path / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])
        calibration = np.loadtxt(
            self.dataset_path / "calibration.txt", delimiter=" ",
            dtype=np.float32,
        )
        _, (H, W) = self.get_img_shape()
        self.camera_intrinsics = Intrinsics.from_calib(
            self.cfg, self.img_size, W, H, calibration
        )


class SevenScenesDataset(MonocularDataset):
    """dataloader.py:137-148."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = _natsorted(
            (self.dataset_path / "seq-01").glob("*.color.png")
        )
        self.timestamps = list(
            np.arange(0, len(self.rgb_files)).astype(self.dtype)
        )
        self.camera_intrinsics = Intrinsics.from_calib(
            self.cfg, self.img_size, 640, 480, [585.0, 585.0, 320.0, 240.0]
        )


class MP4Dataset(MonocularDataset):
    """Video file via cv2 (dataloader.py:231-265; no torchcodec path)."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        cv2 = _cv2()
        self.cap = cv2.VideoCapture(str(self.dataset_path))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.stride = int(self.cfg.get("dataset", {}).get("subsample", 1))
        self.timestamps = []

    def __len__(self):
        return self.total_frames // self.stride

    def subsample(self, subsample):
        self.stride = max(self.stride, int(subsample))

    def get_timestamp(self, idx):
        return idx * self.stride / self.fps

    def read_img(self, idx):
        cv2 = _cv2()
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, idx * self.stride)
        ret, img = self.cap.read()
        if not ret:
            raise ValueError(f"Failed to read frame {idx}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class RGBFiles(MonocularDataset):
    """Plain folder of PNGs (dataloader.py:268-274)."""

    def __init__(self, dataset_path, cfg: dict | None = None):
        super().__init__(cfg)
        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = _natsorted(self.dataset_path.glob("*.png"))
        self.timestamps = list(
            np.arange(0, len(self.rgb_files)).astype(self.dtype) / 30.0
        )
        # Optional calibration sidecar (new convenience for synthetic clips)
        calib_file = self.dataset_path / "calibration.txt"
        if calib_file.exists():
            calib = np.loadtxt(calib_file, dtype=np.float32)
            _, (H, W) = self.get_img_shape()
            self.camera_intrinsics = Intrinsics.from_calib(
                self.cfg, self.img_size, W, H, calib
            )


class RealsenseDataset(MonocularDataset):  # pragma: no cover - hw needed
    """Live Realsense stream (dataloader.py:151-203); requires
    pyrealsense2."""

    def __init__(self, cfg: dict | None = None):
        super().__init__(cfg)
        import pyrealsense2 as rs

        self.dataset_path = None
        self.pipeline = rs.pipeline()
        self.h, self.w = 480, 640
        self.rs_config = rs.config()
        self.rs_config.enable_stream(
            rs.stream.color, self.w, self.h, rs.format.bgr8, 30
        )
        self.profile = self.pipeline.start(self.rs_config)
        self.rgb_profile = rs.video_stream_profile(
            self.profile.get_stream(rs.stream.color)
        )
        self.save_results = False
        if self.use_calibration:
            ri = self.rgb_profile.get_intrinsics()
            self.camera_intrinsics = Intrinsics.from_calib(
                self.cfg, self.img_size, self.w, self.h,
                [ri.fx, ri.fy, ri.ppx, ri.ppy],
            )

    def __len__(self):
        return 999999

    def read_img(self, idx):
        cv2 = _cv2()
        frameset = self.pipeline.wait_for_frames()
        self.timestamps.append(frameset.get_timestamp() / 1000)
        rgb_frame = frameset.get_color_frame()
        img = np.asanyarray(rgb_frame.get_data())
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Webcam(MonocularDataset):  # pragma: no cover - hw needed
    """dataloader.py:206-228."""

    def __init__(self, cfg: dict | None = None):
        super().__init__(cfg)
        self.use_calibration = False
        self.dataset_path = None
        self.cap = _cv2().VideoCapture(-1)
        self.save_results = False

    def __len__(self):
        return 999999

    def read_img(self, idx):
        cv2 = _cv2()
        ret, img = self.cap.read()
        if not ret:
            raise ValueError("Failed to read image")
        self.timestamps.append(idx / 30)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Intrinsics:
    """Undistortion maps + K rescaled to the network frame
    (dataloader.py:277-317)."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx = mapx
        self.mapy = mapy
        _, (scale_w, scale_h, half_crop_w, half_crop_h) = resize_img(
            np.zeros((H, W, 3), dtype=np.float32), self.img_size,
            return_transformation=True,
        )
        self.K_frame = self.K.copy()
        self.K_frame[0, 0] = self.K[0, 0] / scale_w
        self.K_frame[1, 1] = self.K[1, 1] / scale_h
        self.K_frame[0, 2] = self.K[0, 2] / scale_w - half_crop_w
        self.K_frame[1, 2] = self.K[1, 2] / scale_h - half_crop_h

    def remap(self, img):
        cv2 = _cv2()
        return cv2.remap(img, self.mapx, self.mapy, cv2.INTER_LINEAR)

    @staticmethod
    def from_calib(config, img_size, W, H, calib, always_undistort=False):
        """None unless ``config`` asks for calibration (``use_calib``) or
        the dataset always undistorts."""
        if not config.get("use_calib", False) and not always_undistort:
            return None
        cv2 = _cv2()
        fx, fy, cx, cy = calib[:4]
        distortion = np.zeros(4)
        if len(calib) > 4:
            distortion = np.array(calib[4:])
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        center = config.get("dataset", {}).get("center_principle_point", True)
        K_opt, _ = cv2.getOptimalNewCameraMatrix(
            K, distortion, (W, H), 0, (W, H), centerPrincipalPoint=center
        )
        mapx, mapy = cv2.initUndistortRectifyMap(
            K, distortion, None, K_opt, (W, H), cv2.CV_32FC1
        )
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


def load_dataset(dataset_path: str, cfg: dict | None = None) \
        -> MonocularDataset:
    """Path-sniffing factory (dataloader.py:346).  ``cfg`` is the loaded
    config dict."""
    parts = dataset_path.split("/")
    if "tum" in parts:
        return TUMDataset(dataset_path, cfg)
    if "euroc" in parts:
        return EurocDataset(dataset_path, cfg)
    if "eth3d" in parts:
        return ETH3DDataset(dataset_path, cfg)
    if "7-scenes" in parts:
        return SevenScenesDataset(dataset_path, cfg)
    if "realsense" in parts:
        return RealsenseDataset(cfg)
    if "webcam" in parts:
        return Webcam(cfg)
    ext = parts[-1].split(".")[-1]
    if ext in ("mp4", "avi", "MOV", "mov"):
        return MP4Dataset(dataset_path, cfg)
    # TUM-format folders without 'tum' in the path
    p = pathlib.Path(dataset_path)
    if (p / "rgb.txt").exists() and (p / "calibration.txt").exists():
        return ETH3DDataset(dataset_path, cfg)
    if (p / "rgb.txt").exists():
        return TUMDataset(dataset_path, cfg)
    return RGBFiles(dataset_path, cfg)
