"""The port's sharded BA across two OS processes (the counterpart of
``tests/test_multiprocess_ba.py``): each process joins a gloo group over a
localhost port (``parallel.mesh.init_distributed``), the mesh spans the
processes, one entry each, and the per-iteration (H, g) reduction is an
``all_reduce``.  Both processes must end with bitwise-equal poses, within
2e-4 of the port's single-device solve (JAX's test's tolerance; measured
1.2e-7) and with its iteration count, in the edge and the map mode.  Each
worker runs under a deadline and is killed past it.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from mast3r_slam_torch.ops import ba

from test_ba import H, K, P, W, identity_scene, perturb

HERE = pathlib.Path(__file__).resolve().parent
DEADLINE_S = 120
ATOL = 2e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _padded(arrays, n, pad_poses):
    """Edges (and for the map mode poses and pointmaps) padded to a
    multiple of n with inert rows."""
    T0, Xs, Cs, ii, jj, idx, vm, Q, ev = arrays
    pe = (-ii.shape[0]) % n

    def padE(a, fill=0):
        return np.concatenate([a, np.full((pe,) + a.shape[1:], fill,
                                          a.dtype)])

    pp = (-P) % n if pad_poses else 0
    if pp:
        identity = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
        T0 = np.concatenate([T0, np.tile(identity, (pp, 1))])
        Xs = np.concatenate([Xs, np.zeros((pp,) + Xs.shape[1:], Xs.dtype)])
        Cs = np.concatenate([Cs, np.zeros((pp,) + Cs.shape[1:], Cs.dtype)])
    return dict(T0=T0, Xs=Xs, Cs=Cs, ii=padE(ii), jj=padE(jj),
                idx=padE(idx), vm=padE(vm, False), Q=padE(Q),
                ev=padE(ev, False))


def test_two_process_sharded_ba(tmp_path):
    T_true, *scene = identity_scene()
    arrays = [np.array(a) for a in (perturb(T_true), *scene)]
    inputs = {"K": K, "W": W, "H": H}
    for mode in ("edge", "map"):
        inputs.update({f"{mode}_{k}": v for k, v in
                       _padded(arrays, 2, mode == "map").items()})
    np.savez(tmp_path / "inputs.npz", **inputs)

    addr = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(HERE.parent))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_mp_ba_worker.py"), addr, "2",
         str(rank), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"

    r0, r1 = (np.load(tmp_path / f"result_{r}.npz") for r in (0, 1))
    T1, it1, _, ok1 = ba.gauss_newton(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(K), "ray",
        (W, H), ba.BAConfig(max_iters=10, chunk_points=128))
    for mode in ("edge", "map"):
        np.testing.assert_array_equal(r0[f"T_{mode}"], r1[f"T_{mode}"])
        assert bool(r0[f"ok_{mode}"]) and ok1
        assert int(r0[f"it_{mode}"]) == int(r1[f"it_{mode}"]) == it1
        np.testing.assert_allclose(r0[f"T_{mode}"][:P], T1.numpy(),
                                   atol=ATOL)
    assert float(np.abs(r0["T_edge"] - np.asarray(T_true)).max()) < 1e-3
