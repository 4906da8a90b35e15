"""One process of ``tests/test_torch_multiprocess_ba.py``: joins a gloo
group of CPU processes over a localhost rendezvous, builds the mesh that
spans them (one entry each) and runs the port's edge- and map-sharded BA on
the inputs the test wrote, saving the poses it ends with.  Imports nothing
of JAX.

Usage: python _torch_mp_ba_worker.py <host:port> <n_procs> <rank> <dir>
"""

import pathlib
import sys


def main():
    addr, nproc, rank, out = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), pathlib.Path(sys.argv[4]))
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch
    import torch.distributed as dist

    from mast3r_slam_torch.ops import ba
    from mast3r_slam_torch.parallel import sharded_ba
    from mast3r_slam_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed(addr, nproc, rank, device="cpu")
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.shape["edge"] == nproc
        inp = np.load(out / "inputs.npz")
        cfg = ba.BAConfig(max_iters=10, chunk_points=128)
        res = {}
        for mode, fn in (("edge", sharded_ba.sharded_gauss_newton),
                         ("map", sharded_ba.sharded_gauss_newton_mapshard)):
            args = [torch.from_numpy(inp[f"{mode}_{k}"]) for k in
                    ("T0", "Xs", "Cs", "ii", "jj", "idx", "vm", "Q", "ev")]
            T, it, _, ok = fn(mesh, *args, torch.from_numpy(inp["K"]), "ray",
                              (int(inp["W"]), int(inp["H"])), cfg,
                              return_stats=True)
            res[f"T_{mode}"] = T.numpy()
            res[f"it_{mode}"] = np.int64(it)
            res[f"ok_{mode}"] = np.bool_(ok)
        np.savez(out / f"result_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    print(f"[rank {rank}] done", flush=True)


if __name__ == "__main__":
    main()
