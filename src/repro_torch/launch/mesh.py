"""The serving lane mesh (the reference's
``repro.launch.mesh.make_lane_mesh``).

A :class:`LaneMesh` is a 1-D list of ``torch.device``s under one axis
name, ``"data"``: shard i of the engine's lane batch lives on
``devices[i]``. The reference builds a ``jax.sharding.Mesh`` and lets
``shard_map`` place the blocks; the port's engine is one process driving
every shard from one host loop, so a mesh is only the devices in shard
order. A device may repeat: D shards on one card hold D lane blocks there
(and one copy of the parameters).

The production meshes of the dry run (the reference's
``make_production_mesh`` and ``make_local_mesh``) are
``torch.distributed`` ``DeviceMesh``es with the reference's axis names
and order: ``pod16x16`` = (16, 16) over ("data", "model") and
``pod2x16x16`` = (2, 16, 16) over ("pod", "data", "model"). They live
inside :func:`fake_world`, a ``fake`` process group of exactly the mesh's
size in which this process is rank 0: collectives return at once and move
nothing, so DTensors laid out on it hold rank 0's local shards only.
Nothing is set at import. The reference's ``force_host_device_count`` has
no counterpart: it sets an XLA flag.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

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


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A ``fake`` process group of ``size`` ranks, this process rank 0, for
    the life of the block; destroyed on exit. Raises when a process group
    is already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", rank=0, world_size=int(size),
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks, found "
            f"{have}; build it inside fake_world({need})")
    # the dry run's shards are fake tensors: no device holds them
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod = (16, 16) = 256 ranks ("data", "model"); multi-pod =
    (2, 16, 16) = 512 ranks ("pod", "data", "model"). Call it inside
    ``fake_world(256)`` or ``fake_world(512)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(shape: Tuple[int, ...] = (1, 1),
                    axes: Tuple[str, ...] = ("data", "model")):
    """A small mesh of ``shape`` over ``axes``, inside
    ``fake_world(prod(shape))``."""
    return _mesh(tuple(shape), tuple(axes))
