"""The plain reference against a tiny CPU run of the port: the network,
the matcher, a tracking step and a backend round on the same inputs."""

import copy

import numpy as np
import pytest
import torch

from benchmark import correct, harness
from benchmark.clips import Clip
from benchmark.reference import network
from benchmark.reference.ba import BACfg, solve_poses
from benchmark.reference.matching import MatchCfg, match, q8
from benchmark.tests._tiny import tiny_cell


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(2)
    cell = tiny_cell()
    cfg = cell.config
    arch = harness.load_arch(cfg)
    sd = arch.make_state_dict(cfg, "cpu")
    engine = arch.build_program(cfg, sd, "cpu")
    prec = network.Precision()
    ref = correct.Reference(arch.reference(cfg, sd, prec, "cpu"), prec,
                            cfg["slam"], cfg["img_hw"])
    clip = Clip(cell.traffic, 17, cfg["img_hw"], 2.0)
    return cell, engine, ref, clip


def test_network_outputs_match(tiny):
    cell, engine, ref, clip = tiny
    # each side normalises the uint8 frames itself: the program as its
    # system prepares a frame
    system = _system(cell, engine)
    imgs = [torch.from_numpy(system.prepare_image(clip.frame(t))[0])[None]
            for t in (1, 0)]
    system.terminate()
    (f1, p1), (f2, p2) = (engine.encode(x) for x in imgs)
    prog = engine.decode_pair(f1, p1, f2, p2)
    with network.reference_mode():
        refv = ref.views(clip.frame(1), clip.frame(0))
    for vp, vr in zip(prog, refv):
        for a, b in zip(vp, vr):
            assert correct.rel_rms(a, b) < 1e-5


def test_matcher_matches_bitwise(tiny):
    cell, engine, ref, clip = tiny
    from mast3r_slam_torch.ops import matching as pm

    with network.reference_mode():
        (X1, _, D1, _), (X2, _, D2, _) = ref.views(clip.frame(3),
                                                   clip.frame(0))
    pc = pm.MatchingConfig.from_dict(cell.config["slam"]["matching"])
    h, w = cell.config["img_hw"]
    D8a, D8b = pm._q8_pair(D1, D2.reshape(1, h * w, -1), True)
    idx_p, v_p = pm.match(X1, X2, D8a, D8b.reshape(D2.shape), None, pc)
    init = torch.roll(torch.arange(h * w), 5)[None]
    idx_r, v_r = match(X1, X2, q8(D1), q8(D2), None,
                       MatchCfg.from_dict(cell.config["slam"]["matching"]))
    assert torch.equal(idx_p, idx_r) and torch.equal(v_p, v_r)
    idx_p, _ = pm.match(X1, X2, D8a, D8b.reshape(D2.shape), init, pc)
    idx_r, _ = match(X1, X2, q8(D1), q8(D2), init,
                     MatchCfg.from_dict(cell.config["slam"]["matching"]))
    assert torch.equal(idx_p, idx_r)


def _system(cell, engine):
    from mast3r_slam_torch.pipeline import SLAMSystem

    cfg = copy.deepcopy(cell.config["slam"])
    cfg["single_thread"] = True
    return SLAMSystem(cfg, engine, tuple(cell.config["img_hw"]),
                      device="cpu")


def test_a_tracking_step_matches(tiny):
    cell, engine, ref, clip = tiny
    from mast3r_slam_torch import tracker as pt
    from mast3r_slam_torch.frame import arena_get

    system = _system(cell, engine)
    system.process_frame(0, clip.frame(0))
    kf = arena_get(system.arena, 0)
    fr = system.create_frame(1, clip.frame(1))
    res = pt.track_step(engine, fr, kf, None, system.tracker.cfg)
    with network.reference_mode():
        views = ref.views(clip.frame(1), clip.frame(0))
        out = ref.track(views, dict(kf=(kf.X_canon, kf.C, kf.N, kf.T_WC),
                                    T0=fr.T_WC, idx=None))
    X = views[0][0].reshape(-1, 3)
    # the two networks' float32 outputs differ by ~3e-7 (another order of
    # sums), which flips a few of the random tiny network's matches: the
    # metric moves by ~1e-3 and the solve by ~2e-4
    assert correct.point_gap(res.frame.T_WC, out.T_WC, X) < 1e-3
    assert float(res.new_kf_metric) == pytest.approx(out.new_kf_metric,
                                                     abs=1e-2)


def test_a_backend_round_matches(tiny):
    cell, engine, ref, clip = tiny
    from mast3r_slam_torch.frame import arena_snapshot

    system = _system(cell, engine)
    t = 0
    while system.graph.n_edges < 2:
        system.process_frame(t, clip.frame(t))
        t += 1
        assert t < 40, "the tiny clip made too few keyframes"
    g = system.graph
    snap = arena_snapshot(system.arena)
    n, ne = snap.n_size, g.n_edges
    upd, T_new, _ = g.solve_poses(snap, "ray")
    T_ref = solve_poses(snap.X[:n], snap.C[:n], snap.N[:n], snap.T_WC[:n],
                        g.ii[:ne], g.jj[:ne], *[s[:ne] for s in g._stores()],
                        tuple(cell.config["img_hw"]),
                        BACfg.from_dict(cell.config["slam"]))
    rows = [int(r) for r in np.asarray(upd) if r < n]
    assert rows
    for c, r in enumerate(np.asarray(upd)):
        if r < n:
            assert correct.point_gap(T_new[c], T_ref[int(r)],
                                     snap.X[int(r)]) < 1e-4
