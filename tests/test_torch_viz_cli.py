"""The live viewer on the port's frame loop (``main_torch.py`` without
``--no-viz``), as ``main.py`` runs it.

* ``main_torch.main([... "--oracle", "--cpu", "--viz-port", "0"])`` on the
  16-frame 48x64 oracle clip at ``config/base.yaml`` (the backend on its
  thread): a client thread reads ``/meta`` and ``/cloud`` while the run
  goes on and sees consistent blobs; after the run the viewer has
  published at least twice and holds the system's keyframes, and its
  server thread has ended.
* Pause and single step through ``main_torch.run(..., viewer=)``:
  ``/ctrl?pause=1`` holds the loop before its first frame, each
  ``/ctrl?step=1`` lets exactly one frame through, ``/ctrl?pause=0`` lets
  the run finish.  Every wait has a deadline (``DEADLINE_S``); a frame
  that should not come is waited for ``HOLD_S``.
* A ``--viz-port`` that another server holds fails with ``OSError`` before
  the SLAM system (and its backend thread) is built.
"""

import json
import socket
import struct
import threading
import time
import urllib.request

import pytest
import torch

import main_torch
from mast3r_slam_torch import pipeline, testing, viz_server
from mast3r_slam_torch.pipeline import SLAMSystem
from mast3r_slam_torch.utils.config import load_config

H, W, N_FRAMES = 48, 64, 16
DEADLINE_S, HOLD_S = 60.0, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module, restored after (the
    suite runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    seq = testing.SyntheticSequence(n_frames=N_FRAMES, h=H, w=W, seed=0,
                                    traj_scale=0.5)
    d = tmp_path_factory.mktemp("clip")
    testing.write_clip(seq, d)
    return seq, d


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10).read()


def test_main_torch_serves_the_map_while_it_runs(clip, tmp_path,
                                                 monkeypatch, capsys):
    _, d = clip
    monkeypatch.chdir(tmp_path)
    root = main_torch.pathlib.Path(main_torch.__file__).parent
    (tmp_path / "config").symlink_to(root / "config")
    started = threading.Event()
    viewers, systems, seen, errors = [], [], [], []

    class Kept(viz_server.LiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            viewers.append(self)
            started.set()

    def client():
        try:
            assert started.wait(DEADLINE_S)
            port = viewers[0].port
            while viewers[0]._thread.is_alive():
                meta = json.loads(_get(port, "/meta"))
                blob = _get(port, "/cloud")
                if meta["version"]:
                    npts = struct.unpack("<6I", blob[:24])[0]
                    seen.append((meta["version"], npts, len(blob)))
                time.sleep(0.01)
        except OSError:
            pass        # the run ended and closed the server meanwhile
        except Exception as e:  # re-raised by the test
            errors.append(e)

    run = main_torch.run

    def spy(system, dataset, args, **kw):
        systems.append(system)
        return run(system, dataset, args, **kw)

    monkeypatch.setattr(viz_server, "LiveViewer", Kept)
    monkeypatch.setattr(main_torch, "run", spy)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    rc = main_torch.main(["--dataset", str(d), "--config", "config/base.yaml",
                          "--oracle", "--cpu", "--viz-port", "0",
                          "--save-as", "run"])
    thread.join(timeout=DEADLINE_S)
    out = capsys.readouterr().out
    assert not thread.is_alive() and not errors
    assert rc == 0 and f"done: {N_FRAMES} frames" in out
    (viewer,), (system,) = viewers, systems
    assert f"live viewer: http://127.0.0.1:{viewer.port}/" in out
    assert not viewer._thread.is_alive()
    meta = viewer._meta
    assert meta["version"] >= 2
    assert meta["nkf"] == system.arena.n_size == system.stats["keyframes"]
    assert meta["nkf"] >= 2 and meta["stats"] == system.stats
    assert seen, "the client read no published map during the run"
    assert all(n > 0 and size > 24 + 12 * n for _, n, size in seen)


def _wait(cond, seconds=DEADLINE_S):
    end = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < end, "deadline passed"
        time.sleep(0.005)


def test_pause_and_single_step(clip):
    seq, _ = clip
    cfg = load_config("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = W
    system = SLAMSystem(cfg, testing.OracleEngine(seq, device="cpu"),
                        (H, W), buffer=16, device="cpu")
    frames = []
    process = system.process_frame

    def counted(i, img):
        frames.append(i)
        return process(i, img)

    system.process_frame = counted
    dataset = testing.ClipDataset(seq.images[:6])
    args = main_torch.parse_args(["--no-viz"])
    viewer = viz_server.LiveViewer(port=0)
    errors, summary = [], {}

    def loop():
        try:
            summary.update(main_torch.run(system, dataset, args,
                                          viewer=viewer))
        except Exception as e:  # re-raised by the test
            errors.append(e)

    try:
        _get(viewer.port, "/ctrl?pause=1")
        thread = threading.Thread(target=loop, daemon=True)
        thread.start()
        time.sleep(HOLD_S)
        assert frames == []
        for k in (1, 2):
            _get(viewer.port, "/ctrl?step=1")
            _wait(lambda: len(frames) == k)
            time.sleep(HOLD_S)
            assert frames == list(range(k)) and viewer.get_msg().next == 0
        _get(viewer.port, "/ctrl?pause=0")
        thread.join(timeout=DEADLINE_S)
        assert not thread.is_alive() and not errors
    finally:
        viewer.close()
    assert frames == list(range(6)) and summary["frames"] == 6
    assert viewer._meta["nkf"] == system.arena.n_size
    assert viewer._meta["frame_version"] == 2    # frames 0 and 3


def test_port_in_use_fails_before_the_system_starts(clip, monkeypatch):
    _, d = clip
    built = []

    class Spy(SLAMSystem):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(pipeline, "SLAMSystem", Spy)
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        with pytest.raises(OSError):
            main_torch.main(["--dataset", str(d), "--config",
                             "config/base.yaml", "--oracle", "--cpu",
                             "--viz-port", str(held.getsockname()[1])])
    assert built == []
