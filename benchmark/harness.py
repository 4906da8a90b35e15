"""One run of one cell: set-up, the window, the metrics, the check.

``run.py`` is the command; this module holds the steps, so that the
benchmark's own tools (``calibrate.py``, the tests) drive the same code.
Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (its ``file``), ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``; and what belongs to
one network, ``arch/<architecture>.py``, by the name its configuration
gives.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
ARCH = BENCH / "arch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mast3r_slam_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict        # the configuration file's contents
    traffic: dict
    limits: dict | None
    manifest: dict
    config_file: str | None = None  # as BENCHMARK.json gives it


def load_cell(name: str, root: Path = ROOT, need_limits: bool = True) -> Cell:
    m = load_manifest(root)
    wl = {w["name"]: w for w in m["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    lim_path = BENCH / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else None
    if need_limits and limits is None:
        raise SystemExit(f"no limits file for {name}: {lim_path}")
    return Cell(w, config, traffic, limits, m, cfg_entry["file"])


def imported_forbidden() -> list[str]:
    """Modules of JAX or the JAX package loaded in this process, compared
    by whole top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dirs(root: Path = ROOT):
    """Fixed build and kernel cache directories inside the checkout."""
    base = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def device_info(torch, chips: int) -> dict:
    """The card's name and count; exits without a result when the run
    cannot have the cards the cell asks for."""
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA card (torch.cuda.is_available() "
                         "is False); this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def load_arch(config: dict, file: str | None = None):
    """The module ``arch/<architecture>.py`` that the configuration names
    (``file``, the configuration's file, for the message when it names
    none or one that is not there)."""
    where = file or f"configuration {config.get('name')!r}"
    name = config.get("architecture")
    if not isinstance(name, str) or not name.isidentifier():
        raise SystemExit(f"{where}: no \"architecture\" key naming a file "
                         f"<architecture>.py of {ARCH} (got {name!r})")
    path = ARCH / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"{where}: architecture {name!r} has no file "
                         f"{path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_arch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def precision(config: dict, which: str):
    """The reference's (``which`` "reference") or the control's
    ``Precision`` as the configuration file states them."""
    from .reference.network import Precision

    return Precision(**config["check"][which])


def samples(traffic: dict, seed: int):
    """The tracked frames and the backend round the camera hands the
    check, drawn from the seed."""
    from .clips import stream_rng

    chk = traffic["check"]
    rng = stream_rng(seed, 1000)
    lo, hi = chk["frames"]
    K = int(traffic["keyframe_every"])
    # the first tracked frame, where the tracker starts from the identity
    frames = [1] if chk.get("first") else []
    jumps = [t for t in range(lo, hi) if K and t % K == 0]
    held = [t for t in range(lo, hi)
            if not (K and t % K == 0) and t not in frames]
    n_j = min(int(chk.get("jumps", 0)), len(jumps))
    frames += list(rng.choice(jumps, n_j, replace=False)) if n_j else []
    frames += list(rng.choice(held, int(chk["tracked"]) - len(frames),
                              replace=False))
    ba_round = None
    if chk.get("ba_rounds"):
        a, b = chk["ba_rounds"]
        ba_round = int(rng.integers(a, b + 1))
    return sorted(int(t) for t in frames), ba_round


def read_metric(name: str, run) -> float | None:
    """The metric's own reader, ``metrics/<name>.py``'s ``read(run)``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    seconds: float
    window: tuple               # (go, end) on the host clock
    setup_s: float
    frames: list                # completed (t, start, end, mode, kf)
    attempted: int
    failed: int
    spans: list | None          # (name, thread, start, end)
    attn: list | None           # (start, (B, H, Nq, Nk, Dh))
    trace: object | None        # trace.DeviceTrace
    step_flops: dict            # one frame's network operations
    thread: int                 # the frontend's thread id


def frame_tables(camera, window):
    """(completed frames, attempted, failed): a frame fails when it went to
    relocalization or its keyframe decision is not the schedule's."""
    go, end = window
    done, attempted, failed = [], 0, 0
    for t, t0, t1, mode, kf, *_ in camera.records:
        attempted += 1
        is_kf = kf or mode == "INIT"
        if "RELOC" in mode or is_kf != camera.clip.is_keyframe(t):
            failed += 1
        if t1 <= end:
            done.append((t, t0, t1, mode, is_kf))
    return done, attempted, failed


def margins(camera) -> str:
    """The keyframe metric's margins of the tracked frames: the lowest on
    held frames, the highest on jump frames and their lowest match share,
    the thresholds being the configuration's; and the GN iterations a
    frame ran."""
    rec = camera.records
    held = [r[5] for r in rec
            if r[5] is not None and not camera.clip.is_keyframe(r[0])]
    jump = [(r[5], r[6]) for r in rec
            if r[5] is not None and camera.clip.is_keyframe(r[0])]
    out = (f"metric on held frames min {min(held):.4f}"
           if held else "no held frame")
    if jump:
        out += (f", on jump frames max {max(m for m, _ in jump):.4f}, "
                f"match share min {min(f for _, f in jump):.4f}")
    its = [r[7] for r in rec if r[7] is not None]
    if its:
        out += (f"; GN iterations a frame min {min(its)} median "
                f"{sorted(its)[len(its) // 2]} max {max(its)}")
    return out


def free_cuda(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def spans_by_thread(run: RunData) -> dict:
    """thread id -> [(name, start, end, depth)]: the loop's frames (depth
    0), the wrapped calls inside them (1, ``engine.encode`` 2) and the
    backend's rounds."""
    depth = {"frame": 0, "tracker.track": 1, "engine.encode": 2,
             "backend.round": 0}
    out: dict = {run.thread: [("frame", t0, t1, 0)
                              for _, t0, t1, _, _ in run.frames]}
    for name, th, t0, t1 in run.spans or []:
        out.setdefault(th, []).append((name, t0, t1, depth.get(name, 1)))
    return out


def check(cell: Cell, arch, capture, clip, device, control: bool = False):
    """The compared numbers (and with ``control`` the control's): the
    weights made again from the configuration's seed, the architecture's
    reference built from them, the camera's samples held to it."""
    from . import correct

    cfg = cell.config
    sd = arch.make_state_dict(cfg, device)

    def build(which):
        prec = precision(cfg, which)
        return correct.Reference(arch.reference(cfg, sd, prec, device), prec,
                                 cfg["slam"], cfg["img_hw"])
    ref = build("reference")
    ctl = build("control") if control else None
    from .reference.network import reference_mode
    with reference_mode():
        return correct.numbers(ref, capture, clip, ctl)


def judge(cell: Cell, nums: dict):
    """(correct, [(name, value, limit)]) against the cell's limits; a
    number the run could not read fails."""
    rows, ok = [], True
    if cell.limits is None:
        return None, [(k, v, None) for k, v in sorted(nums.items())]
    for name, lim in cell.limits["limits"].items():
        v = nums.get(name)
        rows.append((name, v, lim["limit"]))
        if v is None or not v <= lim["limit"]:
            ok = False
    return ok, rows


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=print, control: bool = False) -> dict:
    """Set-up, the window, the metrics and the check of one run; returns
    the result line's object (and with ``control`` the control's and the
    program's numbers under ``control`` and ``program``)."""
    import torch

    from .drive import Spans

    arch = load_arch(cell.config, cell.config_file)
    log(f"architecture {cell.config['architecture']}: "
        f"{arch.net_config(cell.config)}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        # the host work of a frame is one Python thread's; PyTorch's CPU
        # pool would only spin beside it
        torch.set_num_threads(1)
        from mast3r_slam_torch import _build
        _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
        # PyTorch loads its CUDA linear algebra lazily, and two threads'
        # first calls race ("lazy wrapper should be called at most once"):
        # load it here, before the backend's thread starts
        a = torch.eye(2, device=device)
        torch.cholesky_solve(a, torch.linalg.cholesky_ex(a)[0])
    sd = arch.make_state_dict(cell.config, device)
    engine = arch.build_program(cell.config, sd, device)
    del sd
    spans = Spans() if traced else None
    patched = []        # (module, its flash_attention)
    if traced:
        engine.encode = spans.wrap("engine.encode", engine.encode)
        # kernel A's launches, counted where the architecture's modules
        # call it
        for name in arch.ATTENTION_MODULES:
            mod = importlib.import_module(name)
            patched.append((mod, mod.flash_attention))
            mod.flash_attention = spans.count_attention(mod.flash_attention)
    held = [engine]
    del engine
    try:
        return _run(cell, arch, held, seed, seconds, device, t_start, log,
                    control, spans, cuda)
    finally:
        for mod, fn in patched:
            mod.flash_attention = fn


def _run(cell, arch, held, seed, seconds, device, t_start, log, control,
         spans, cuda):
    """``held`` = [engine], emptied here so that the engine goes with the
    program's state before the reference runs."""
    import torch

    from .clips import Clip
    from .drive import Camera, Capture, make_system_factory
    from .trace import DeviceTrace

    engine = held.pop()
    capture = Capture(*samples(cell.traffic, seed))
    engine.decode_pair = capture.wrap_decode(engine.decode_pair)
    clip = Clip(cell.traffic, seed, cell.config["img_hw"], seconds)
    camera = Camera(clip, capture,
                    make_system_factory(cell.config["slam"], engine,
                                        cell.config["img_hw"]), spans)
    del engine
    if cuda:
        torch.cuda.synchronize()
    trace = DeviceTrace() if spans is not None and cuda else None
    setup_s = time.perf_counter() - t_start
    # the trace records the card from before the window opens until the
    # last frame has finished (stopping the profiler while the backend
    # thread launches can crash it)
    if trace is not None:
        trace.start()
    go = time.perf_counter()
    window = (go, go + seconds)
    camera.run(window[1])
    t_drain = time.perf_counter()
    camera.system.terminate()
    drain_s = time.perf_counter() - t_drain
    if trace is not None:
        t_parse = time.perf_counter()
        trace.stop(window)
        log(f"device trace: {len(trace.ops)} operations, read in "
            f"{time.perf_counter() - t_parse:.1f} s")
    frames, attempted, failed = frame_tables(camera, window)
    kf = sum(1 for r in frames if r[4])
    log(f"window {seconds} s: {len(frames)} frames completed of {attempted} "
        f"attempted, {failed} failed, {kf} keyframes, {capture.rounds} "
        f"backend rounds with edges; drain and stop {drain_s:.3f} s; "
        f"frame_ms_p90 over {len(frames)} samples; {margins(camera)}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = RunData(seconds, window, setup_s, frames, attempted, failed,
                  spans.items if spans else None,
                  spans.attn if spans else None, trace,
                  arch.model_step(cell.config), camera.thread)
    m = cell.manifest
    metrics = {}
    for e in (m["per_layer"] if spans is not None else m["end_to_end"]):
        if "workloads" in e and cell.workload["name"] not in e["workloads"]:
            continue
        v = read_metric(e["name"], run)
        if v is not None:
            metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s()
        breakdown = {"device_ops": trace.top_ops(10),
                     "idle_gaps": trace.idle_gaps(spans_by_thread(run), 10)}
    # the program's state goes before the reference runs
    camera.system = None
    del camera
    if cuda:
        free_cuda(torch)
    prog, ctrl = check(cell, arch, capture, clip, device, control)
    samples_read = {"program": prog.pop("samples"),
                    "control": ctrl.pop("samples")}
    ok, rows = judge(cell, prog)
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["program"], out["control"] = prog, ctrl
        out["samples"] = samples_read
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out
