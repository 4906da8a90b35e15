"""The port's benchmark (``bench_torch.py``, ``mast3r_slam_torch/tools/
bench.py``) against ``bench.py``.

* ``compose_protocol`` against ``bench.py:689-735``'s formula at cases
  computed by hand: ``desc_global``, the symmetric batch with more than one
  proposal a round, per-proposal pricing, a host-bound frame and the
  assumed rates; exact to 1e-12.
* ``load_rates`` reads the committed ``bench_rates.json`` as ``bench.py``
  does (3 GN and 10 BA iterations, its rates) and refuses what it refuses;
  ``BENCH_RATES_FORCE`` overrides.
* ``BENCH_SMALL=1 BENCH_CPU=1 BENCH_CHAIN=2 python bench_torch.py`` prints
  one JSON line with ``bench.py``'s keys and ``drive_tracked_frame``,
  positive stages, a headline that is the composition of its printed
  stages; without ``BENCH_CPU`` and without a card it prints nothing and
  exits non-zero.  With ``BENCH_BA_UNCACHED``, ``BENCH_GN_ITERS``,
  ``BENCH_BA_ITERS`` and ``BENCH_KF_RATE`` set, the full BA solve runs and
  the overrides reach the solves and the assumed-rates figure.
* The track stage's call (the tiny model at 96x128, the bench's
  accept-everything matcher and ``TrackerConfig``) against JAX's
  ``tracker.track_step`` on the same numpy inputs (the port's encoder
  features and keyframe pointmap): the same 3 GN iterations, and the pose
  within 2e-2 with each side's own matcher (read 4.33e-3: the LM's
  last-bit drift, ROADMAP C.6, moves 0.50% of the matches to a
  neighbour, and the bench's gates let every match into the solve), and
  within 1e-4 when the port's step takes JAX's matches (read 3.28e-5), so
  the wider figure is the matcher's flips and nothing else.  The solve
  moves the pose from the identity by more than twice the wider tolerance
  (read 0.40), so a step that left it unchanged would fail.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import tracker as jtrk
from mast3r_slam_tpu.frame import make_empty_frame
from mast3r_slam_tpu.inference import InferenceEngine as JaxEngine
from mast3r_slam_tpu.models.convert import convert_state_dict
from mast3r_slam_tpu.models.mast3r import MASt3R as JaxMASt3R
from mast3r_slam_tpu.models.mast3r import MASt3RConfig as JaxConfig
from mast3r_slam_tpu.ops import matching as jmatch
from mast3r_slam_torch.models.mast3r import MASt3RConfig
from mast3r_slam_torch.testing import build_seeded_engine
from mast3r_slam_torch.tools import bench
from mast3r_slam_torch.tracker import track_step

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACK_POSE_ATOL, TRACK_SHARED_POSE_ATOL = 2e-2, 1e-4
EXACT = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread in this module (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGES = {"encode": 40.0, "track": 60.0, "create_frame_host": 10.0,
          "kf_edge_reused": 5.0, "kf_ba_solve": 20.0, "retrieval_ms": 5.0,
          "retrieval_edge_sym": 100.0, "retrieval_edge_sym2": 150.0,
          "retrieval_edge_desc": 8.0}


@pytest.mark.parametrize("case", [
    # desc_global: each proposal pays the pose-free match plus the
    # symmetric fallback at its rate: 0.2 * (8 + 0.5 * 100) = 11.6
    dict(mode="desc_global", kf=0.1, retr=0.2, fb=0.5, stages={},
         sym=11.6, ms=100 + 0.1 * 30 + 11.6, assumed=100 + 0.2 * 30),
    # symmetric, 2.5 proposals a keyframe round: one batch, its marginal
    # edge 150 - 100: 0.1 * (100 + 1.5 * 50) = 17.5
    dict(mode="sym", kf=0.1, retr=0.25, fb=0.5, stages={},
         sym=17.5, ms=100 + 3 + 17.5, assumed=106.0),
    # symmetric, 0.5 proposals a round: per proposal, 0.1 * 100
    dict(mode="sym", kf=0.2, retr=0.1, fb=0.0, stages={},
         sym=10.0, ms=100 + 6 + 10.0, assumed=106.0),
    # a two-edge batch cheaper than one edge: the marginal edge is 0
    dict(mode="sym", kf=0.1, retr=0.3, fb=0.0,
         stages={"retrieval_edge_sym2": 90.0},
         sym=0.1 * 100.0, ms=100 + 3 + 10.0, assumed=106.0),
    # the host's frame preparation slower than the device frame
    dict(mode="sym", kf=0.2, retr=0.0, fb=0.0,
         stages={"create_frame_host": 150.0},
         sym=0.0, ms=150 + 6.0, assumed=156.0),
    # assumed rates (no rates file): no retrieval, the assumed kf rate
    dict(mode="desc_global", kf=0.2, retr=0.0, fb=0.0, stages={},
         sym=0.0, ms=106.0, assumed=106.0),
], ids=["desc_global", "sym_batched", "sym_per_proposal", "sym2_cheaper",
        "host_bound", "assumed"])
def test_compose_protocol_is_bench_py_formula(case):
    stages = dict(STAGES, **case["stages"])
    rates = {"kf_rate": case["kf"], "retrieval_edge_rate": case["retr"],
             "desc_fallback_rate": case["fb"], "kf_rate_assumed": 0.2}
    out = bench.compose_protocol(stages, rates, case["mode"])
    assert abs(out["sym_frame_ms"] - case["sym"]) <= EXACT
    assert abs(out["protocol_ms"] - case["ms"]) <= EXACT
    assert abs(out["protocol_fps"] - 1e3 / case["ms"]) <= EXACT
    assert abs(out["protocol_fps_assumed"] - 1e3 / case["assumed"]) <= EXACT
    assert out["frame_ms"] == 100.0


def test_load_rates_reads_the_committed_file():
    with open(REPO / "bench_rates.json") as f:
        committed = json.load(f)
    r = bench.load_rates(str(REPO / "bench_rates.json"), force=False)
    assert (r.gn_iters, r.ba_iters) == (3, 10)
    assert r.src == str(REPO / "bench_rates.json")
    assert r.kf_rate == committed["kf_rate"]
    assert r.retrieval_edge_rate == committed["retrieval_proposal_rate"]
    assert r.retrieval_accept_rate == committed["retrieval_edge_rate"]
    assert r.desc_fallback_rate == committed["desc_fallback_rate"]
    # the knobs override the cadence only
    r2 = bench.load_rates(str(REPO / "bench_rates.json"), False, 0.2,
                          gn_iters=50, ba_iters=4)
    assert (r2.gn_iters, r2.ba_iters, r2.kf_rate) == (50, 4, r.kf_rate)


def _write(tmp_path, **over):
    rates = {"frames": 150, "kf_rate": 0.1, "retrieval_edge_rate": 0.05,
             "retrieval_proposal_rate": 0.08, "mean_gn_iters": 4.6,
             "mean_ba_iters": 7.4, "desc_fallback_rate": 0.25,
             "retrieval_active": True, "reference_exact": False}
    rates.update(over)
    path = tmp_path / "rates.json"
    path.write_text(json.dumps(rates))
    return str(path)


@pytest.mark.parametrize("over,force,accepted,cadence", [
    ({}, False, True, (5, 7)),
    # measured under reference_exact: neither the cadence nor the rates,
    # also when forced
    ({"reference_exact": True}, False, False, (50, 10)),
    ({"reference_exact": True}, True, False, (50, 10)),
    # a test-fixture clip: the cadence is read, the rates refused
    ({"frames": 40}, False, False, (5, 7)),
    ({"frames": 40}, True, True, (5, 7)),
    # retrieval structurally absent
    ({"retrieval_active": False, "retrieval_proposal_rate": 0.0,
      "retrieval_edge_rate": 0.0}, False, False, (5, 7)),
    ({"retrieval_active": False, "retrieval_proposal_rate": 0.0,
      "retrieval_edge_rate": 0.0}, True, True, (5, 7)),
    # a measured zero with retrieval on is a measurement
    ({"retrieval_proposal_rate": 0.0, "retrieval_edge_rate": 0.0}, False,
     True, (5, 7)),
], ids=["valid", "reference_exact", "reference_exact_forced", "few_frames",
        "few_frames_forced", "no_retrieval", "no_retrieval_forced",
        "measured_zero"])
def test_load_rates_rejection_rules(tmp_path, over, force, accepted,
                                    cadence):
    path = _write(tmp_path, **over)
    r = bench.load_rates(path, force, kf_rate=0.2)
    assert (r.gn_iters, r.ba_iters) == cadence
    if accepted:
        measured = json.loads(pathlib.Path(path).read_text())
        assert r.src == path
        assert r.kf_rate == measured["kf_rate"]
        assert r.retrieval_edge_rate == measured["retrieval_proposal_rate"]
        assert r.desc_fallback_rate == measured["desc_fallback_rate"]
    else:
        assert (r.src, r.kf_rate, r.retrieval_edge_rate,
                r.desc_fallback_rate) == ("assumed", 0.2, 0.0, 0.0)


def test_load_rates_without_a_file(tmp_path):
    r = bench.load_rates(str(tmp_path / "none.json"), False, kf_rate=0.3)
    assert r == bench.Rates(50, 10, 0.3, 0.0, 0.0, 0.0, "assumed")


def test_knobs_read_bench_py_environment():
    k = bench.Knobs.from_env({})
    assert k == bench.Knobs(False, 16, False, "bench_rates.json", False,
                            0.2, 0, 0, False, True)
    k = bench.Knobs.from_env({"BENCH_SMALL": "1", "BENCH_RATES_FORCE": "1",
                              "BENCH_CHAIN": "4", "BENCH_CPU": "1"})
    assert (k.small, k.rates_force, k.chain, k.cpu, k.int8_encoder) == \
        (True, True, 4, True, False)
    assert not bench.Knobs.from_env({"BENCH_INT8_ENC": "0"}).int8_encoder


def test_run_with_thread_runs_both_and_raises_the_threads_error():
    """The threaded figure's helper: the frontend's calls on this thread,
    the backend's on a Python thread, both counted; the thread's error is
    raised here, and with no backend calls no thread runs."""
    calls = {"front": 0, "back": 0}

    def front():
        calls["front"] += 1

    def back():
        calls["back"] += 1

    dev = torch.device("cpu")
    assert bench.run_with_thread(front, 5, back, 3, dev) >= 0
    assert calls == {"front": 5, "back": 3}
    assert bench.run_with_thread(front, 2, back, 0, dev) >= 0
    assert calls == {"front": 7, "back": 3}

    def broken():
        raise ArithmeticError("backend round failed")

    with pytest.raises(ArithmeticError, match="backend round failed"):
        bench.run_with_thread(front, 1, broken, 1, dev)


def _bench_env(**over):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(OMP_NUM_THREADS="1", **over)
    return env


@pytest.fixture(scope="module", autouse=True)
def small_run():
    """``BENCH_SMALL=1 BENCH_CPU=1 BENCH_CHAIN=2 python bench_torch.py``,
    started with the module so that it runs beside the module's other
    tests; the test that reads it waits for it under a deadline."""
    proc = subprocess.Popen(
        [sys.executable, "bench_torch.py"], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_bench_env(BENCH_SMALL="1", BENCH_CPU="1", BENCH_CHAIN="2"))
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


# the override knobs of bench.py:20-30 that bench_rates.json otherwise sets
KNOBS_RUN = {"BENCH_BA_UNCACHED": "1", "BENCH_GN_ITERS": "2",
             "BENCH_BA_ITERS": "4", "BENCH_KF_RATE": "0.5"}


@pytest.fixture(scope="module", autouse=True)
def knobs_run():
    """``small_run`` with one call a stage and ``KNOBS_RUN``'s overrides:
    the full BA solve in place of the cached one, 2 GN and 4 BA
    iterations, the assumed keyframe rate 0.5."""
    proc = subprocess.Popen(
        [sys.executable, "bench_torch.py"], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_bench_env(BENCH_SMALL="1", BENCH_CPU="1", BENCH_CHAIN="1",
                       **KNOBS_RUN))
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_override_knobs_reach_the_stages(knobs_run):
    """The track stage and the BA solve refuse to run other than their
    cadence's iterations, so a record is the proof that 2 GN and 4 BA
    iterations ran; the BA stage is the uncached solve alone (no refresh,
    no cached solve), and the assumed-rates figure composes at 0.5."""
    out, err = knobs_run.communicate(timeout=600)
    assert knobs_run.returncode == 0, err[-4000:]
    rec = json.loads(out)
    b = rec["breakdown_ms"]
    assert (b["gn_iters"], b["ba_iters"]) == (2, 4)
    assert b["kf_ba_solve"] > 0
    assert "  kf_ba_solve: " in err
    assert "ba_refresh" not in err and "ba_cached_solve" not in err
    bench.check_record(rec, kf_rate_assumed=0.5)
    with pytest.raises(ValueError, match="assumed"):
        bench.check_record(rec)


def test_without_a_card_or_bench_cpu_it_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=_bench_env(BENCH_SMALL="1"))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert len(proc.stderr.strip().splitlines()) == 1, proc.stderr
    assert "no CUDA device" in proc.stderr


def test_track_stage_matches_jax_track_step():
    gn_iters = 3
    engine, sd = build_seeded_engine(
        MASt3RConfig.tiny(), bench.SMALL_HW, 0, device="cpu",
        match_cfg=bench.bench_matching_config())
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((1, *bench.SMALL_HW, 3), generator=gen)
    frame0, kf, idx0 = bench.track_inputs(engine, img)
    tcfg = bench.bench_tracker_config(gn_iters)
    tres = track_step(engine, frame0, kf, idx0, tcfg)

    h, w = bench.SMALL_HW
    jcfg = JaxConfig.tiny()
    params = convert_state_dict(sd, jcfg.enc_depth, jcfg.dec_depth)
    mc = engine.match_cfg
    jengine = JaxEngine(JaxMASt3R(jcfg), params, (h, w),
                        match_cfg=jmatch.MatchingConfig(**mc._asdict()))
    jt = jtrk.TrackerConfig(C_conf=-1e9, Q_conf=-1e9, rel_error=0.0,
                            delta_norm=0.0, max_iters=gn_iters)
    assert jt._asdict() == {k: v for k, v in tcfg._asdict().items()
                            if k in jt._fields}

    def jframe(fr):
        return make_empty_frame(h, w, engine.n_patches,
                                jcfg.enc_embed_dim).replace(
            feat=jnp.asarray(fr.feat.numpy()),
            pos=jnp.asarray(fr.pos.numpy(), jnp.int32),
            X_canon=jnp.asarray(fr.X_canon.numpy()),
            C=jnp.asarray(fr.C.numpy()),
            N=jnp.asarray(int(fr.N), jnp.int32),
            N_updates=jnp.asarray(int(fr.N_updates), jnp.int32))

    impl = jengine._match_asymmetric_desc_impl

    @jax.jit
    def step(params, frame, keyframe, idx):
        def matcher(f1, p1, f2, p2, idx):
            return impl(params, f1, p1, f2, p2, idx)
        return jtrk.track_step(matcher, frame, keyframe, idx, jnp.eye(3),
                               jt)

    jres = step(jengine.params, jframe(frame0), jframe(kf),
                jnp.asarray(idx0.numpy(), jnp.int32))
    assert int(jres.gn_iters) == tres.gn_iters == gn_iters
    assert bool(jres.ok) and tres.ok
    err = np.abs(tres.frame.T_WC.numpy() - np.asarray(jres.frame.T_WC))
    # the solve moves the pose well past both tolerances, so a step that
    # left the identity would fail them
    moved = np.abs(np.asarray(jres.frame.T_WC)
                   - frame0.T_WC.numpy()).max()

    class _JaxMatches:
        """The port's engine with JAX's matches in place of its own."""

        def __getattr__(self, name):
            return getattr(engine, name)

        def match_asymmetric(self, *args):
            outs = list(engine.match_asymmetric(*args))
            outs[0] = torch.from_numpy(np.array(jres.idx_f2k)).long()
            outs[1] = torch.from_numpy(np.array(jres.valid_match))
            return tuple(outs)

    shared = track_step(_JaxMatches(), frame0, kf, idx0, tcfg)
    err_shared = np.abs(shared.frame.T_WC.numpy()
                        - np.asarray(jres.frame.T_WC))
    flips = float((tres.idx_f2k.numpy() != np.asarray(jres.idx_f2k)).mean())
    print(f"track stage pose against JAX: {err.max():.3g} with each side's "
          f"matcher ({flips:.2%} of the matches differ), "
          f"{err_shared.max():.3g} with JAX's matches; the pose moved "
          f"{moved:.3g} from the identity")
    assert moved >= max(10 * TRACK_SHARED_POSE_ATOL, 2 * TRACK_POSE_ATOL)
    assert shared.gn_iters == gn_iters and shared.ok
    assert err.max() <= TRACK_POSE_ATOL
    assert err_shared.max() <= TRACK_SHARED_POSE_ATOL


def test_small_cpu_run_prints_bench_py_record(small_run):
    out, err = small_run.communicate(timeout=600)
    assert small_run.returncode == 0, err[-4000:]
    lines = out.splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert tuple(rec) == bench.RECORD_KEYS
    assert tuple(rec["breakdown_ms"]) == bench.BREAKDOWN_KEYS
    b = rec["breakdown_ms"]
    assert all(b[k] > 0 for k in bench.STAGE_KEYS), b
    assert b["retrieval_edge_desc2"] > 0
    assert b["int8_encoder"] is False
    assert b["encode"] == b["encode_bf16"]
    assert (b["gn_iters"], b["ba_iters"]) == (3, 10)
    assert b["rates_src"] == "bench_rates.json"
    assert b["drive_tracked_frame"] is None or b["drive_tracked_frame"] > 0
    assert rec["protocol_fps_2chip"] is None
    assert rec["metric"] == "protocol_fps_per_chip"
    # the headline and the tracked rate are compositions of the printed
    # stages, to the rounding of their print
    bench.check_record(rec)
    bad = json.loads(lines[0])
    bad["value"] = round(bad["value"] + 0.01, 3)
    with pytest.raises(ValueError, match="composition"):
        bench.check_record(bad)
    assert "bench_torch: launches attention 0 pack 0 gn_solve 0" in err
