"""The device mesh of the port's multi-device work (``parallel/mesh.py``).

A ``Mesh`` is an ``(n_edge, n_model)`` grid of ``torch.device`` entries
with JAX's axis names: ``edge`` shards the factor graph's edges (and, in
map mode, the keyframe pointmaps) of the bundle adjustment, ``model``
splits the network's attention heads and MLP columns (tensor parallelism).
JAX places arrays on the mesh and lets ``shard_map`` / GSPMD run the
shards and insert the collectives; here the shards are lists of tensors,
one per entry, and the collectives are written out:

* in one process the entries are devices of that process (possibly the
  same device repeated, which is how the tests and one card run a mesh of
  several entries): the shards run one after the other, each on its
  entry's device, and a reduction is a sum in a fixed order, entry by
  entry, onto the first entry's device;
* after ``init_distributed`` a mesh spans the processes, one entry each:
  every process runs its own entry, and a reduction is
  ``torch.distributed.all_reduce`` (gloo on the CPU, NCCL on cards), so
  every process ends with the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import device as _device

AXES = ("edge", "model")


class Mesh:
    """An ``(n_edge, n_model)`` grid of devices with axes ("edge", "model")
    (``jax.sharding.Mesh``).  ``rank`` is this process's entry (row-major)
    when the mesh spans processes, None when all entries are this
    process's."""

    def __init__(self, devices, rank: int | None = None):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-d grid, got shape "
                             f"{arr.shape}")
        self.devices = arr
        self.rank = rank

    @property
    def shape(self) -> dict:
        """{"edge": n_edge, "model": n_model}, as ``Mesh.shape`` in JAX."""
        return dict(zip(AXES, self.devices.shape))

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The entries along ``axis`` in the first row or column."""
        if axis == "edge":
            return list(self.devices[:, 0])
        if axis == "model":
            return list(self.devices[0, :])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def local_edge_entries(self) -> list[tuple[int, torch.device]]:
        """(index along ``edge``, device) of the edge entries this process
        runs: all of them in one process, its own across processes."""
        if self.distributed:
            n_model = self.devices.shape[1]
            return [(self.rank // n_model,
                     self.devices.flat[self.rank])]
        return list(enumerate(self.axis_devices("edge")))

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={self.devices.tolist()}"
                + (f", rank={self.rank}" if self.distributed else "") + ")")


def make_mesh(n_edge: int | None = None, n_model: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """(mesh.py:17)  The first ``n_edge * n_model`` of ``devices`` (default:
    ``device.local_devices()``) as an ``(n_edge, n_model)`` mesh; ``n_edge``
    defaults to ``len(devices) // n_model``.  A caller may repeat a device
    (a test's CPU, the one card).  After ``init_distributed`` and without
    ``devices``, the mesh spans the processes, one entry each, this
    process's entry on its own device."""
    import torch.distributed as dist

    rank = None
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        own = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        devices = [own] * world
    elif devices is None:
        devices = _device.local_devices()
    devices = list(devices)
    n = len(devices)
    if n_edge is None:
        n_edge = n // n_model
    if n_edge < 1 or n_model < 1 or n_edge * n_model > n:
        raise ValueError(f"a ({n_edge}, {n_model}) mesh needs "
                         f"{n_edge * n_model} devices, have {n}")
    if rank is not None and n_edge * n_model != n:
        raise ValueError(f"a mesh across {n} processes has one entry each, "
                         f"got ({n_edge}, {n_model})")
    grid = [devices[r * n_model:(r + 1) * n_model] for r in range(n_edge)]
    return Mesh(grid, rank=rank)


# -- placement and collectives (edge_sharding / replicated, mesh.py:28-35) --

def split(t, n: int, dim: int = 0) -> list:
    """``t`` cut into ``n`` equal blocks along ``dim`` (JAX's
    ``P("edge")`` layout); raises unless ``n`` divides it."""
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide over {n} entries")
    return list(torch.chunk(t, n, dim=dim))


def edge_shards(mesh: Mesh, t, dim: int = 0) -> list:
    """The blocks of ``t`` along ``dim`` that this process's edge entries
    hold, each on its entry's device (``edge_sharding``)."""
    blocks = split(t, mesh.shape["edge"], dim)
    return [blocks[e].to(dev) for e, dev in mesh.local_edge_entries()]


def replicate(mesh: Mesh, t) -> list:
    """A copy of ``t`` on each of this process's edge entries
    (``replicated``); an entry on ``t``'s own device gets ``t`` itself."""
    return [t.to(dev) for _, dev in mesh.local_edge_entries()]


def reduce_sum(mesh: Mesh, parts: list):
    """The sum over the edge axis of the entries' ``parts`` (``psum``): in
    one process, entry by entry in index order onto the first entry's
    device; across processes, ``all_reduce`` of this process's part, which
    leaves the same bits in every process."""
    if mesh.distributed:
        import torch.distributed as dist

        (part,) = parts
        out = part.clone()
        dist.all_reduce(out)
        return out
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def reduce_scatter(mesh: Mesh, parts: list, dim: int = 0) -> list:
    """``psum_scatter(tiled=True)`` over the edge axis: ``parts`` are the
    entries' full-length contributions; entry e gets the sum over entries of
    block e along ``dim``, on its own device, summed in entry order.
    Across processes the whole sum is reduced and the process keeps its
    block (gloo has no reduce-scatter)."""
    n = mesh.shape["edge"]
    if mesh.distributed:
        (e, _), = mesh.local_edge_entries()
        return [split(reduce_sum(mesh, parts), n, dim)[e]]
    out = []
    for e, dev in mesh.local_edge_entries():
        acc = split(parts[0], n, dim)[e].to(dev)
        for p in parts[1:]:
            acc = acc + split(p, n, dim)[e].to(dev)
        out.append(acc)
    return out


# -- tensor parallelism (shard_params_tp, mesh.py:37) ------------------------

class TPShards(NamedTuple):
    """One block's Megatron split over the mesh's ``model`` axis: each
    entry's device and its pieces of the block's weights (``nn.Linear``
    layout, (out, in))."""
    devices: tuple
    parts: tuple


def _head_rows(n_heads: int, head_dim: int, n: int, e: int,
               groups: int = 1):
    """Output rows of entry e's heads in a (groups * C, C) weight whose rows
    are ``groups`` stacked (heads, head_dim) blocks (the fused qkv: q, k
    and v, each head by head)."""
    per = n_heads // n
    C = n_heads * head_dim
    return torch.cat([torch.arange(g * C + e * per * head_dim,
                                   g * C + (e + 1) * per * head_dim)
                      for g in range(groups)])


def shard_params_tp(model, mesh: Mesh):
    """Tensor-parallel placement of the network over ``mesh``'s ``model``
    axis (mesh.py:37), in place: every self-attention, cross-attention and
    MLP of the encoder and both decoders gets a ``tp`` attribute
    (``TPShards``) with each entry's pieces, copied to its device, which
    ``models/mast3r.py`` runs as a Megatron block: the fused ``qkv`` (and
    the cross-attention's ``projq`` / ``projk`` / ``projv``) and ``fc1``
    split by output columns, so that an entry holds the whole q, k and v of
    its ``H / n_model`` heads and its slice of the hidden layer; ``proj``
    and ``fc2`` split by input rows, each entry's product a partial sum.
    Everything else stays whole on the model's device: the patch
    embedding, the decoder embedding, the LayerNorms, the DPT and catMLP
    heads, and the biases of ``proj`` and ``fc2``, added once after the
    sum.  JAX computes the same function with other placements
    (``/proj/`` also matches the patch embedding, the cross-attention's
    input projections stay replicated, the heads' MLP is split), as GSPMD
    reshards around them.  Runs within one process.  Returns ``model``."""
    if mesh.distributed:
        raise ValueError("tensor-parallel inference runs its model axis "
                         "within one process")
    devs = tuple(mesh.axis_devices("model"))
    n = len(devs)
    if n == 1:
        return model

    def attn_parts(m, cross):
        H = m.num_heads
        Dh = m.proj.weight.shape[0] // H
        if H % n:
            raise ValueError(f"{H} heads do not split over {n} entries")
        parts = []
        for e, dev in enumerate(devs):
            rows = _head_rows(H, Dh, n, e)
            cols = rows
            p = {"proj_w": m.proj.weight[:, cols].contiguous().to(dev)}
            if cross:
                for name in ("projq", "projk", "projv"):
                    lin = getattr(m, name)
                    p[name + "_w"] = lin.weight[rows].contiguous().to(dev)
                    p[name + "_b"] = lin.bias[rows].contiguous().to(dev)
            else:
                rows3 = _head_rows(H, Dh, n, e, groups=3)
                p["qkv_w"] = m.qkv.weight[rows3].contiguous().to(dev)
                p["qkv_b"] = m.qkv.bias[rows3].contiguous().to(dev)
            parts.append(p)
        return TPShards(devs, tuple(parts))

    def mlp_parts(m):
        hidden = m.fc1.weight.shape[0]
        if hidden % n:
            raise ValueError(f"an MLP of {hidden} does not split over {n}")
        k = hidden // n
        return TPShards(devs, tuple(
            {"fc1_w": m.fc1.weight[e * k:(e + 1) * k].contiguous().to(dev),
             "fc1_b": m.fc1.bias[e * k:(e + 1) * k].contiguous().to(dev),
             "fc2_w": m.fc2.weight[:, e * k:(e + 1) * k].contiguous().to(dev)}
            for e, dev in enumerate(devs)))

    with torch.no_grad():
        for blk in model.enc_blocks:
            blk.attn.tp = attn_parts(blk.attn, cross=False)
            blk.mlp.tp = mlp_parts(blk.mlp)
        for blk in list(model.dec_blocks) + list(model.dec_blocks2):
            blk.attn.tp = attn_parts(blk.attn, cross=False)
            blk.cross_attn.tp = attn_parts(blk.cross_attn, cross=True)
            blk.mlp.tp = mlp_parts(blk.mlp)
    return model


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device: str = "cuda") -> None:
    """(mesh.py:57)  Join a group of ``num_processes`` processes through the
    TCP rendezvous at ``coordinator_address`` ("host:port", e.g.
    ``localhost:29500``) as rank ``process_id``: gloo for ``device`` "cpu",
    NCCL on the cards (rank r takes card ``r % device_count``).  After it,
    ``make_mesh()`` spans the processes, one entry each."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
