"""Device selection for the port's entry points, and the one place that
counts the devices a run may use."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index ("cuda" is the card
    current at the call), so that a thread with another card current (the
    backend device's) still places this device's tensors on it, and two
    names of one device compare equal; raises if it names CUDA and no card
    is present.  Entry points never fall back to the CPU on their own: a
    caller that wants the CPU (the tests) passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(kind="cuda") -> list[torch.device]:
    """The devices of this process that multi-device work may use, in index
    order (JAX's ``jax.devices()``): ``cuda:0 .. cuda:n-1`` for ``kind``
    "cuda" (an empty list without a card), ``[cpu]`` for "cpu".  Every
    "how many devices" question of the port (the backend device, the
    sharded BA's mesh, ``--tp``) goes through this function, so that a test
    can give the CPU several entries by patching it."""
    kind = torch.device(kind).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"local_devices: unsupported device kind {kind!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

