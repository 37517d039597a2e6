"""Device meshes of the port (the counterpart of ``repro/launch/mesh.py``).

A :class:`Mesh` names its axes, their sizes and the ``torch.device`` of each
position (row-major over the axes). The serving engine takes a
``(data, model)`` mesh through ``EngineConfig.mesh`` and splits the model
over the ``model`` axis (``distributed/sharding.py``); one process drives
every shard. Building a mesh touches no device: it only names them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """Named axes of sizes ``axis_sizes`` over ``devices`` (one per
    position, row-major), or a shape-only mesh (``devices=None``): the
    sharding rules read its shape, but nothing can be placed on it."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple | None = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def placed_devices(self) -> tuple:
        """The mesh's devices, row-major; ValueError on a shape-only
        mesh."""
        if self.devices is None:
            raise ValueError(f"the {self.shape} mesh is shape-only: it has "
                             "no devices to place tensors on")
        return self.devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout, (data=16, model=16) or (pod=2, data=16,
    model=16), shape-only: for the sharding rules' specs."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, *, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` of
    ``devices`` (default: the visible CUDA cards, none without a card).

    A list may name one device several times: shards on one card, or on
    the CPU (``devices=[torch.device("cpu")] * 4``), run the same code as
    shards on separate cards, one after another. ValueError on an axis
    below 1 or when fewer devices are given than the mesh needs."""
    if data < 1 or model < 1:
        raise ValueError(
            f"mesh axes must be positive, got data={data} model={model}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need, have = data * model, len(devices)
    if need > have:
        raise ValueError(
            f"requested a {data}x{model} (data x model) mesh = {need} "
            f"devices but only {have} are visible; pass devices= (one device "
            f"may repeat) to place several shards on one, or shrink the mesh")
    return Mesh(("data", "model"), (data, model), tuple(devices[:need]))
