#!/usr/bin/env python3
"""Command-line entry point of the PyTorch + CUDA port's dense SLAM pipeline.

The counterpart of ``main.py``: load a dataset, build the engine and the
SLAM system (``mast3r_slam_torch``: tracking, the factor-graph backend, the
ASMK retrieval database and relocalization; the encoder and the local-feature
MLPs in int8 on request), loop
``SLAMSystem.process_frame`` over the frames, export the keyframe
trajectory (TUM format), the point cloud (PLY) and the keyframe images,
write the protocol rates (``--rates-out``) and score ATE against a ground
truth.  The backend runs on a thread under ``single_thread: False``
(``config/base.yaml``) and inline after each keyframe under ``single_thread:
True`` (the eval configs).  ``--state-out`` saves the SLAM state after the
last frame and ``--resume-state`` restores one before the first (with
``--start-frame``, a run in segments).  A run that ends lost (in RELOC)
says so and exits 0, as ``main.py`` does.  ``--tp N`` splits the network
over N devices (tensor parallel) and ``--backend-device I`` runs the
backend on device I, as ``main.py`` runs them.  The live WebGL viewer
(``viz_server.LiveViewer``) serves the map on localhost (``--viz-port``)
unless ``--no-viz`` is given: it can pause the loop and step it one frame
at a time.

    python3 main_torch.py --dataset <clip> --config config/base.yaml

Runs on the CUDA card unless ``--cpu`` is given.  The flags are
``main.py``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset",
                   default="datasets/tum/rgbd_dataset_freiburg1_desk")
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--save-as", default="default")
    p.add_argument("--no-viz", action="store_true",
                   help="headless: no live viewer (map export still runs)")
    p.add_argument("--viz-port", type=int, default=8089,
                   help="live WebGL viewer port (serves on localhost; 0 "
                        "takes a free port)")
    p.add_argument("--calib", default="",
                   help="intrinsics yaml override (config/intrinsics.yaml "
                        "schema)")
    p.add_argument("--retrieval-checkpoint",
                   default="checkpoints/"
                           "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric"
                           "_retrieval_trainingfree.pth",
                   help="retrieval head of the ASMK database (loop closure "
                        "and relocalization proposals); with --codebook")
    p.add_argument("--codebook",
                   default="checkpoints/"
                           "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric"
                           "_codebook.pkl",
                   help="ASMK codebook pickle of the database")
    p.add_argument("--checkpoint",
                   default="checkpoints/"
                           "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric"
                           ".pth",
                   help="MASt3R ViT-L checkpoint (the published file, or "
                        "a bare state dict), loaded strictly")
    p.add_argument("--tiny-model", action="store_true",
                   help="random tiny model (plumbing smoke runs only)")
    p.add_argument("--oracle", action="store_true",
                   help="oracle engine from the clip's oracle.npz "
                        "(synthetic clips; drives the system without "
                        "checkpoint weights)")
    p.add_argument("--fp32-head", action="store_true",
                   help="run the DPT/catMLP heads in float32 (the exact "
                        "reference autocast policy) instead of the default "
                        "bf16-compute/fp32-postprocess fast path")
    p.add_argument("--int8-encoder", action="store_true",
                   help="int8 encoder: per-channel int8 weights, per-token "
                        "int8 activations, the card's int8 product "
                        "(models/quant.py; no effect with --oracle)")
    p.add_argument("--int8-local-head", action="store_true",
                   help="the catMLP local-feature MLPs in int8 the same "
                        "way (no effect with --oracle)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--gt", default="", help="TUM-format GT for ATE scoring")
    p.add_argument("--ate-max-diff", type=float, default=0.01,
                   help="timestamp association window of the built-in ATE")
    p.add_argument("--oracle-desc", action="store_true",
                   help="with --oracle: the oracle also exports q8 world "
                        "descriptors, which turns on the descriptor paths "
                        "(pose-warped consecutive edge tables, desc_global "
                        "retrieval edges)")
    p.add_argument("--oracle-retrieval", action="store_true",
                   help="with --oracle: an ASMK database over the clip's "
                        "own view signatures "
                        "(testing.make_oracle_retrieval), so loop-closure "
                        "and relocalization proposals fire")
    p.add_argument("--diag-out", default="",
                   help="per-frame diagnostics JSONL (match_frac, gn_iters, "
                        "keyframe decisions, pose)")
    p.add_argument("--rates-out", default="logs/rates.json",
                   help="where to write the run's protocol rates (the "
                        "rates dict printed at the end, main.py's keys)")
    p.add_argument("--profile", action="store_true",
                   help="record the frame path's spans and print their "
                        "host-clock times at the end (no device "
                        "synchronisation: a section's time is the host's)")
    p.add_argument("--profile-blocks", action="store_true",
                   help="after the run, time the network's sub-blocks "
                        "(PatchEmbed / enc attn / enc mlp / dec self + "
                        "cross + mlp) and print the per-frame summary "
                        "(utils/breakdown.py)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--start-frame", type=int, default=0,
                   help="first (post-subsample) frame index to process")
    p.add_argument("--reference-exact", action="store_true",
                   help="full-res matcher walk and per-component Huber: the "
                        "reference-exact bundle")
    p.add_argument("--resume-state", default=None,
                   help="SLAM-state file (save_state format, the port's or "
                        "main.py's) to restore before the first frame; an "
                        "empty retrieval database is replayed from its "
                        "keyframes")
    p.add_argument("--state-out", default=None,
                   help="write the SLAM state after the last frame (a run "
                        "in segments chains these with --start-frame)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of the network: attention "
                        "heads and MLP columns split over a 'model' mesh "
                        "axis of this size (one reduction per attention and "
                        "per MLP; parallel/mesh.py shard_params_tp); no "
                        "effect with --oracle")
    p.add_argument("--backend-device", type=int, default=None,
                   help="run the backend (the keyframe rounds' decodes, "
                        "matches and BA) on this device index, with a "
                        "mirror of the keyframe arena there (pipeline.py)")
    return p.parse_args(argv)


def load_model(args):
    """The network of ``--tiny-model`` (seeded random weights) or the ViT-L
    one with the ``--checkpoint`` file loaded strictly
    (``models/convert.py::load_checkpoint``: a published checkpoint or a
    bare state dict); bf16 heads unless ``--fp32-head`` (main.py:123-160)."""
    import torch

    from mast3r_slam_torch.models.convert import load_checkpoint
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig

    head_dtype = torch.float32 if args.fp32_head else torch.bfloat16
    if args.tiny_model:
        torch.manual_seed(0)
        return MASt3R(MASt3RConfig.tiny(head_dtype=head_dtype))
    ckpt = pathlib.Path(args.checkpoint)
    if not ckpt.exists():
        sys.exit(f"checkpoint not found: {ckpt}\n"
                 "Put the MASt3R ViT-L state dict there, or pass "
                 "--tiny-model or --oracle for a run without weights.")
    return load_checkpoint(
        MASt3R(MASt3RConfig.vit_large(head_dtype=head_dtype)), ckpt)


def wait_for_step(viewer):
    """Hold the loop while the viewer is paused, until a single step is
    asked for, and take that step (main.py:317-325)."""
    msg = viewer.get_msg()
    while msg.is_paused and msg.next == 0:
        time.sleep(0.05)
        msg = viewer.get_msg()
    if msg.is_paused:
        viewer.consume_step()


def publish_map(viewer, system, edges=True):
    """The map to the viewer: the keyframes whose rows changed, the poses
    and, with ``edges``, the graph's edges, read under the system's lock
    (main.py:338-342).  The backend writes ``ii`` / ``jj`` before it raises
    ``n_edges``, so ``n_edges`` is read first."""
    g = system.graph
    ne = int(g.n_edges)
    ii, jj = (g.ii[:ne], g.jj[:ne]) if edges else (None, None)
    viewer.publish(system.arena, ii, jj, stats=system.stats,
                   lock=system._lock)


def run(system, dataset, args, viewer=None):
    """The frame loop (main.py:288-358) as a function of the system, a
    dataset (``len``, ``dataset[i] -> (timestamp, image)``) and the parsed
    arguments (``max_frames``, ``start_frame``, ``diag_out``).  The next
    frame's host work (read, undistort, resize, normalise) runs on one
    prefetch thread while the device works on the current one.  With
    ``args.state_out`` the state is saved after the last frame.  A frame
    that loses tracking puts the system in RELOC, where the next frames try
    to relocalize, as in ``main.py``.  With a ``viz_server.LiveViewer`` the
    loop waits before each frame while the viewer is paused (a step lets
    one frame through), publishes every third frame's image and, on a new
    keyframe or every 15th frame, the map, and the map once more after
    ``terminate``, at ``main.py``'s cadence.  Returns the run's summary
    (``lost_at``: the first frame that lost tracking; ``lost_at_end``: the
    run ended in RELOC)."""
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    i0 = max(int(args.start_frame), 0)
    system.diag = bool(args.diag_out)

    def load(idx):
        ts, raw = dataset[idx]
        return ts, raw, system.prepare_image(raw)

    lost_at = None
    done = 0
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1) as prefetch:
        diag_f = None
        if args.diag_out:
            dp = pathlib.Path(args.diag_out)
            dp.parent.mkdir(parents=True, exist_ok=True)
            diag_f = open(dp, "w")
        try:
            fut = prefetch.submit(load, i0) if i0 < n else None
            for i in range(i0, n):
                if viewer is not None:
                    wait_for_step(viewer)
                timestamp, raw, prepared = fut.result()
                if i + 1 < n:
                    fut = prefetch.submit(load, i + 1)
                info = system.process_frame(i, prepared)
                done += 1
                if diag_f is not None:
                    info["i"] = i
                    info["ts"] = float(timestamp)
                    diag_f.write(json.dumps(info) + "\n")
                if viewer is not None and i % 3 == 0:
                    viewer.publish_frame(raw)
                if viewer is not None and (info["new_kf"] or i % 15 == 0):
                    publish_map(viewer, system)
                if system.mode.name == "RELOC" and lost_at is None:
                    lost_at = i
                    print(f"[lost] tracking lost at frame {i}; "
                          f"relocalizing")
                if i % 30 == 0 and i > 0:
                    print(f"FPS: {done / (time.time() - t0):.2f}  "
                          f"mode={info['mode']} "
                          f"kf={system.stats['keyframes']}")
        finally:
            if diag_f is not None:
                diag_f.close()
    try:
        # the rounds still queued (a relocalization among them) end the run
        system.drain()
        lost_at_end = system.mode.name == "RELOC"
        if args.state_out:
            # before terminate, which leaves the mode TERMINATED
            # (main.py:347)
            system.save_state(args.state_out)
            print(f"state saved to {args.state_out}")
    finally:
        system.terminate()
    if viewer is not None:
        publish_map(viewer, system, edges=False)
    wall = time.time() - t0
    trk = system.tracker
    rounds = system.stats["ba_rounds"]
    return {
        "frames": done,
        "seconds": wall,
        "fps": done / max(wall, 1e-9),
        "lost_at": lost_at,
        "lost_at_end": lost_at_end,
        "stats": dict(system.stats),
        "kf_rate": system.stats["keyframes"] / max(done, 1),
        "mean_gn_iters": trk.gn_iters_total / max(trk.gn_frames, 1),
        "ba_rounds": rounds,
        "mean_ba_iters": system.ba_iters_total / max(rounds, 1),
    }


def protocol_rates(system, n, args, config, retrieval_active):
    """The run's protocol rates with ``main.py``'s keys (main.py:365-410):
    keyframes, accepted non-consecutive edges and retrieval proposals per
    frame over ``n`` frames, mean GN and BA iterations, the share of BA
    rounds that solved, the desc_global batches and the share of proposals
    that fell back to the symmetric decode, and the run's provenance."""
    stats, g, trk = system.stats, system.graph, system.tracker
    rounds = max(stats["ba_rounds"], 1)
    return {
        "frames": n,
        "kf_rate": stats["keyframes"] / max(n, 1),
        "retrieval_edge_rate": stats["retrieval_edges"] / max(n, 1),
        "retrieval_proposal_rate": stats["retrieval_proposals"] / max(n, 1),
        "mean_gn_iters": trk.gn_iters_total / max(trk.gn_frames, 1),
        "mean_ba_iters": system.ba_iters_total / rounds,
        "ba_ok_rate": system.ba_ok_total / rounds,
        "desc_edge_batches": int(g.n_desc_batches),
        "desc_fallback_rate": int(g.n_desc_fallbacks)
        / max(stats["retrieval_proposals"], 1),
        "config": str(args.config),
        "dataset": str(args.dataset),
        "retrieval_active": bool(retrieval_active),
        "reference_exact": bool(args.reference_exact
                                or config.get("reference_exact", False)),
    }


def export(system, dataset, args):
    """Trajectory, reconstruction and keyframes under ``logs/`` and, with
    ``--gt``, the ATE (main.py:416-429).  Returns the ATE or None."""
    from mast3r_slam_torch import evaluate

    save_dir, seq_name = evaluate.prepare_savedir(args.save_as, dataset)
    evaluate.save_traj(save_dir, f"{seq_name}.txt", dataset.timestamps,
                       system.arena)
    evaluate.save_reconstruction(save_dir, f"{seq_name}.ply", system.arena,
                                 1.5, K=system.K)
    evaluate.save_keyframes(save_dir / "keyframes" / seq_name,
                            dataset.timestamps, system.arena)
    print(f"results: {save_dir}/{seq_name}.txt, .ply")
    if not args.gt:
        return None
    ate = evaluate.ate_rmse(args.gt, save_dir / f"{seq_name}.txt",
                            max_diff=args.ate_max_diff)
    print(f"ATE RMSE (Sim3-aligned): {ate:.4f} m")
    return ate


def main(argv=None):
    args = parse_args(argv)

    import torch
    import yaml

    from mast3r_slam_torch.dataloader import Intrinsics, load_dataset
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.ops.matching import MatchingConfig
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.utils.config import (apply_reference_exact,
                                                load_config)
    from mast3r_slam_torch.utils.profiler import TRACER

    device = "cpu" if args.cpu else "cuda"
    config = load_config(args.config)
    if args.reference_exact:
        config = apply_reference_exact(config)
    if args.calib:
        config["use_calib"] = True
    print(f"dataset: {args.dataset}")
    print(f"device: {device}" + (
        f" ({torch.cuda.get_device_name(0)})"
        if device == "cuda" and torch.cuda.is_available() else ""))

    dataset = load_dataset(args.dataset, config)
    dataset.subsample(config["dataset"]["subsample"])
    (h, w), _ = dataset.get_img_shape()

    if args.calib:
        with open(args.calib) as f:
            intr = yaml.safe_load(f)
        dataset.use_calibration = True
        dataset.camera_intrinsics = Intrinsics.from_calib(
            config, dataset.img_size, intr["width"], intr["height"],
            intr["calibration"])

    use_calib = bool(config["use_calib"])
    if use_calib and not dataset.has_calib():
        sys.exit("[error] use_calib=True but no calibration available")
    K = dataset.camera_intrinsics.K_frame if use_calib else None

    if args.oracle:
        from mast3r_slam_torch.testing import OracleEngine, SyntheticSequence

        seq = SyntheticSequence.load(
            pathlib.Path(args.dataset) / "oracle.npz")
        sub = int(config["dataset"]["subsample"])
        seq.X_cam = seq.X_cam[::sub]
        seq.X_world = seq.X_world[::sub]
        seq.T_WC = seq.T_WC[::sub]
        h, w = seq.h, seq.w
        config["dataset"]["img_size"] = max(h, w)
        engine = OracleEngine(seq, export_desc=args.oracle_desc,
                              device=device)
        # the oracle carries frame identity in an encode-call counter:
        # align it with the first processed frame
        engine._encode_counter = max(int(args.start_frame), 0)
        K = seq.K if use_calib else None
    else:
        mesh = None
        if args.tp > 1:
            from mast3r_slam_torch.device import local_devices
            from mast3r_slam_torch.parallel.mesh import make_mesh

            devs = local_devices(device)
            if len(devs) >= args.tp:
                mesh = make_mesh(n_edge=len(devs) // args.tp,
                                 n_model=args.tp, devices=devs)
            else:
                print(f"--tp {args.tp} needs {args.tp} devices, have "
                      f"{len(devs)}; running unsharded")
        engine = InferenceEngine(
            load_model(args), (h, w),
            downsample=int(config["dataset"].get("img_downsample", 1)),
            match_cfg=MatchingConfig.from_dict(config["matching"]),
            device=device, int8_encoder=args.int8_encoder,
            int8_local_head=args.int8_local_head, mesh=mesh)
    retrieval = None
    if args.oracle:
        if args.oracle_retrieval:
            from mast3r_slam_torch.testing import make_oracle_retrieval

            retrieval = make_oracle_retrieval(seq, engine)
            print("oracle retrieval database on (loop-closure proposals "
                  "from the clip's own view signatures)")
    else:
        rc = pathlib.Path(args.retrieval_checkpoint)
        cb = pathlib.Path(args.codebook)
        if rc.exists() and cb.exists():
            from mast3r_slam_torch.retrieval.database import \
                RetrievalDatabase

            retrieval = RetrievalDatabase.from_checkpoint(str(rc), str(cb),
                                                          device=device)
            print("retrieval database loaded (ASMK loop closure on)")
        else:
            print("[warn] retrieval checkpoint/codebook not found - "
                  "loop closure and relocalization proposals disabled")
    viewer = None
    if not args.no_viz:
        from mast3r_slam_torch.viz_server import LiveViewer

        # bound before the system starts its backend thread: a port in use
        # fails here, with nothing yet to stop
        viewer = LiveViewer(port=args.viz_port)
        print(f"live viewer: http://127.0.0.1:{viewer.port}/")
    if args.profile:
        TRACER.reset()
        TRACER.enable()
    try:
        system = SLAMSystem(config, engine, (h, w), K=K, retrieval=retrieval,
                            device=device, backend_device=args.backend_device)
        if args.resume_state:
            system.load_state(args.resume_state)
            print(f"resumed from {args.resume_state}: "
                  f"{system.arena.n_size} keyframes, mode={system.mode}")
        summary = run(system, dataset, args, viewer=viewer)
    finally:
        if args.profile:
            TRACER.disable()
        if viewer is not None:
            viewer.close()
    print(f"done: {summary['frames']} frames in {summary['seconds']:.1f}s "
          f"({summary['fps']:.2f} FPS)")
    print(f"stats: {summary['stats']}")
    if summary["lost_at_end"]:
        print("[lost] the run ended in RELOC: tracking was not recovered")
    print(f"rates: kf_rate {summary['kf_rate']:.4f} mean_gn_iters "
          f"{summary['mean_gn_iters']:.2f} ba_rounds {summary['ba_rounds']} "
          f"mean_ba_iters {summary['mean_ba_iters']:.2f}")
    graph = system.graph
    if graph.retrieval_edge_mode == "desc_global":
        print(f"desc_global edge batches: {graph.n_desc_batches}")
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    rates = protocol_rates(system, n, args, config, retrieval is not None)
    print(f"rates: {rates}")
    if args.rates_out:
        rp = pathlib.Path(args.rates_out)
        rp.parent.mkdir(parents=True, exist_ok=True)
        with open(rp, "w") as f:
            json.dump(rates, f)

    if getattr(dataset, "save_results", True):
        export(system, dataset, args)
    if args.profile:
        TRACER.print_summary()
    if args.profile_blocks and not (args.oracle or args.tiny_model):
        from mast3r_slam_torch.utils.breakdown import (network_breakdown,
                                                       print_network_summary)

        print_network_summary(network_breakdown(engine.model, (h, w)))
    elif args.profile_blocks:
        print("[profile-blocks] skipped (oracle/tiny run has no full net)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
