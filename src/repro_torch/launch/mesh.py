"""The serving lane mesh (the reference's
``repro.launch.mesh.make_lane_mesh``).

A :class:`LaneMesh` is a 1-D list of ``torch.device``s under one axis
name, ``"data"``: shard i of the engine's lane batch lives on
``devices[i]``. The reference builds a ``jax.sharding.Mesh`` and lets
``shard_map`` place the blocks; the port's engine is one process driving
every shard from one host loop, so a mesh is only the devices in shard
order. A device may repeat: D shards on one card hold D lane blocks there
(and one copy of the parameters). The reference's ``make_local_mesh``
and ``force_host_device_count`` have no counterpart: the first builds
2-D XLA meshes and the second sets an XLA flag.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` with an explicit index on CUDA (``cuda`` names the
    current card), so two spellings of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class LaneMesh:
    """D lane shards: ``devices[i]`` holds shard i's contiguous block of
    W/D lanes. ``axis_names`` is the reference's ``Mesh.axis_names``
    (``("data",)`` for a serving mesh; the engine rejects any other)."""

    def __init__(self, devices: Iterable[DeviceLike],
                 axis_names: Tuple[str, ...] = ("data",)) -> None:
        self.devices: Tuple[torch.device, ...] = tuple(
            canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a lane mesh needs at least one device")
        if len(tuple(axis_names)) != 1:
            raise ValueError(f"a lane mesh is 1-D, got axes {axis_names}")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        """{axis name: shard count}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: self.size}

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices without repeats, in shard order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"LaneMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_lane_mesh(num_devices: Optional[int] = None,
                   device: DeviceLike = "cuda") -> LaneMesh:
    """1-D ``("data",)`` serving mesh. On ``cuda``: the first
    ``num_devices`` visible cards (``None``: all of them), one shard each;
    asking for more than are visible raises. On ``cpu``: ``num_devices``
    CPU shards (``None``: one), the counterpart of the reference's forced
    host devices. D shards on one card are built explicitly:
    ``LaneMesh([torch.device("cuda:0")] * D)``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"a lane mesh needs >= 1 shard, got {n}")
        return LaneMesh([dev] * n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    visible = torch.cuda.device_count()
    n = visible if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"a lane mesh needs >= 1 shard, got {n}")
    if n > visible:
        raise RuntimeError(
            f"lane mesh over {n} devices but only {visible} visible; lower "
            "--mesh, or put several shards on one card explicitly: "
            f"LaneMesh([torch.device('cuda:0')] * {n})")
    return LaneMesh([torch.device("cuda", i) for i in range(n)])
