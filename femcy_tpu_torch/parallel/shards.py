"""What the port's sharded solvers share: one process drives every shard.

- shard d's tensors live on ``devices[d]``; the list may name one device
  more than once (several shards on one card, as XLA's virtual host
  devices put several on one CPU);
- a psum is the sum of the shards' partial results in shard order, on the
  first shard's device (``psum``), so reruns match bit for bit; a pmax is
  the maximum over the shards (``pmax``), read once a CG iteration;
- ``all_gather``, ``psum_scatter`` and ``ppermute`` become copies between
  the shards' tensors (``to``);
- ``Blocks`` holds one tensor per shard, so that ``system.run_newton``'s
  arithmetic on the working dof acts shard by shard.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from femcy_tpu_torch.utils.device import resolve_device


class Blocks:
    """One tensor per shard, each on its shard's device.  ``+``, ``-``
    and scaling by a Python number act shard by shard: what
    ``system.run_newton`` does to its dof and Newton step."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, d):
        return self.parts[d]

    def __add__(self, other: "Blocks") -> "Blocks":
        return Blocks(a + b for a, b in zip(self.parts, other.parts))

    def __sub__(self, other: "Blocks") -> "Blocks":
        return Blocks(a - b for a, b in zip(self.parts, other.parts))

    def __mul__(self, scale: float) -> "Blocks":
        return Blocks(a * scale for a in self.parts)

    __rmul__ = __mul__


def to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (a copy between shards when they differ)."""
    return t if t.device == device else t.to(device)


def psum(parts) -> torch.Tensor:
    """The sum of the shards' partials, in shard order, on the first
    shard's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + to(p, total.device)
    return total


def pmax(parts) -> torch.Tensor:
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, to(p, total.device))
    return total


def indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (tensors report "cuda:0", not "cuda")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_devices(devices: Optional[list]) -> List[torch.device]:
    """The shards' devices: ``devices`` (torch devices or names, a device
    may repeat), by default one shard per CUDA card; a CUDA device without
    a card raises (``resolve_device``)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = devices or ["cuda"]  # no card: resolve_device raises
    return [indexed(resolve_device(d)) for d in devices]


def gather(parts, device: torch.device, cache: dict) -> torch.Tensor:
    """The all_gather of the shards' blocks: their concatenation in shard
    order on ``device``, made once per distinct device (``cache``, keyed
    by device, is the caller's for one gather)."""
    full = cache.get(device)
    if full is None:
        full = torch.cat([to(p, device) for p in parts])
        cache[device] = full
    return full
