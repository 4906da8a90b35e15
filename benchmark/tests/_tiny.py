"""A cell at a size the CPU test run holds: the network and frames its
architecture's ``tiny`` cuts it to, small arenas; the configuration,
traffic and check otherwise those of a committed cell."""

from __future__ import annotations

import copy
import json


# the tiny cells: (configuration, traffic mix); the pan-hold mix is no
# committed cell yet, and drives the backend's part of the check here
CELLS = {"vitl512-bf16.solo-panhold": ("mast3r-vitl512-bf16", "solo-panhold"),
         "vitl512-int8.solo-still": ("mast3r-vitl512-int8", "solo-still")}


def tiny_cell(workload="vitl512-bf16.solo-panhold", limits=None,
              architecture=None):
    """The tiny copy of ``workload``; with ``architecture`` its
    configuration names that architecture in place of its own."""
    from benchmark import harness

    config, traffic = CELLS[workload]
    file = f"benchmark/configs/{config}.json"
    cfg = json.loads((harness.ROOT / file).read_text())
    if architecture is not None:
        cfg["architecture"] = architecture
    cfg = harness.load_arch(cfg, file).tiny(cfg)
    cell = harness.Cell(
        dict(name=workload, config=config, traffic=traffic, chips=1), cfg,
        json.loads((harness.BENCH / "traffic" / f"{traffic}.json")
                   .read_text()), None, harness.load_manifest(), file)
    cfg["slam"]["map"]["buffer"] = 16
    cfg["slam"]["local_opt"]["max_edges"] = 16
    tr = copy.deepcopy(cell.traffic)
    tr["max_rate_fps"] = 20
    if tr["keyframe_every"]:
        tr["jump_px"] = 24
    tr["check"] = dict(tr["check"], frames=[1, 9], tracked=2,
                       jumps=min(1, tr["check"].get("jumps", 0)))
    if tr["check"].get("ba_rounds"):
        tr["check"]["ba_rounds"] = [1, 1]
    cell.traffic = tr
    cell.limits = limits
    return cell


# limits of the tiny cells.  The bf16 configuration's tiny copy computes
# in float32 on both sides, so its gaps are rounding, which flips a few of
# the random tiny network's matches and so moves the pose and the keyframe
# metric (a jump frame's pose misses ~3% of the reference's move, the
# first tracked frame's ~0.5%, a pose left unchanged all of it); the int8
# encoder keeps its bf16 residual stream and attention whatever the
# trunk's dtype, against the reference's float32 (the first frame's pose
# misses ~18% of the move)
TINY_LIMITS = {
    "vitl512-bf16.solo-panhold": {"limits": {
        "net_gap": {"limit": 1e-5}, "kf_decisions": {"limit": 0},
        "ba_gap": {"limit": 1e-3}, "jump_pose_miss": {"limit": 0.2},
        "start_pose_miss": {"limit": 0.1}}},
    "vitl512-int8.solo-still": {"limits": {
        "net_gap": {"limit": 2e-2}, "kf_decisions": {"limit": 0},
        "start_pose_miss": {"limit": 0.6}}},
}
