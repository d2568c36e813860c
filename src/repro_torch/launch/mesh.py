"""Device meshes for one controller process.

Port of ``src/repro/launch/mesh.py`` together with the part of
``jax.sharding.Mesh`` the DSPC system reads.  A :class:`Mesh` is a
named grid of ``torch.device`` entries; the process that holds it
drives every entry itself (there are no SPMD ranks), so the service's
updater thread, its readers and its pullers keep running in one process
as they do on the reference.

A device may repeat in a mesh: ``make_mesh((4,), ("model",),
devices=["cpu"] * 4)`` gives four edge shards on the CPU, and four
entries of ``cuda:0`` give four shards on one card.  Work placed on
repeated entries runs on that one device; a copy of a replicated
tensor is made once per *distinct* device.

The reference's TPU roofline constants have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import resolve_device


def canonical_device(device) -> torch.device:
    """``device`` as its tensors report it (``"cuda"`` names the current
    card, ``"cpu:0"`` is ``"cpu"``), so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    return dev


class Mesh:
    """A named grid of devices (the counterpart of ``jax.sharding.Mesh``).

    ``devices`` is a read-only object array of ``torch.device`` with one
    axis per name in ``axis_names``; ``shape`` maps each axis name to
    its size, in axis order.  Meshes are immutable, hashable and equal
    when their names, shape and devices are equal, so callers can memoise
    on them.
    """

    __slots__ = ("devices", "axis_names", "_key")

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        raw = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if raw.ndim != len(names):
            raise ValueError(
                f"mesh devices have {raw.ndim} axes but {len(names)} "
                f"names {names}")
        if raw.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(set(names)) != len(names) or not all(
                isinstance(a, str) and a for a in names):
            raise ValueError(
                f"mesh axis names must be distinct non-empty strings, "
                f"got {names}")
        arr = np.empty(raw.shape, dtype=object)
        for i, d in enumerate(raw.reshape(-1)):
            arr.flat[i] = canonical_device(d)
        arr.flags.writeable = False
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "_key", (names, arr.shape, tuple(arr.flat)))

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")

    @property
    def shape(self) -> Mapping[str, int]:
        """Axis name -> size, in axis order (``mesh.shape[ax]``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in the order of its first entry."""
        return tuple(dict.fromkeys(self.devices.flat))

    def axis_devices(self, axes: Iterable[str]) -> Tuple[torch.device, ...]:
        """The devices along ``axes`` (row-major in the order given), at
        position 0 of every other axis: one entry per shard of data
        split over those axes and replicated over the rest."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(
                f"axes {missing} not on the mesh (axes: {self.axis_names})")
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        moved = np.transpose(self.devices, pos + rest)
        grid = moved.reshape(math.prod(moved.shape[:len(pos)]), -1)
        return tuple(grid[:, 0])


def _devices(devices) -> list:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device on this host; pass devices= (e.g. "
                "['cpu'] * 4) to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return list(np.asarray(devices, dtype=object).reshape(-1))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices`` (default: every
    visible CUDA device), which must fill it exactly; entries may
    repeat."""
    shape = tuple(int(s) for s in shape)
    devs = _devices(devices)
    if len(devs) != math.prod(shape):
        raise ValueError(
            f"a mesh of shape {shape} needs {math.prod(shape)} devices, "
            f"got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


#: The production mesh's model axis (the reference's 16 x 16 pod), or
#: every device of a pod when it holds fewer.
PRODUCTION_MODEL_AXIS = 16


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production layout over the devices present (default: every
    visible CUDA device): axes ``("data", "model")``, or ``("pod",
    "data", "model")`` over two pods, with a model axis of up to
    ``PRODUCTION_MODEL_AXIS`` devices.  Raises when the devices do not
    fill it."""
    devs = _devices(devices)
    pods = 2 if multi_pod else 1
    per_pod = len(devs) // pods
    mdl = min(PRODUCTION_MODEL_AXIS, per_pod)
    if mdl < 1 or len(devs) % (pods * mdl):
        raise ValueError(
            f"{len(devs)} devices do not fill {pods} pod(s) of "
            f"data x model with a model axis of {mdl}")
    if multi_pod:
        return make_mesh((pods, per_pod // mdl, mdl),
                         ("pod", "data", "model"), devs)
    return make_mesh((per_pod // mdl, mdl), ("data", "model"), devs)


def make_host_mesh(device="cuda") -> Mesh:
    """Degenerate 1x1 ``("data", "model")`` mesh on one device (smoke
    tests)."""
    return make_mesh((1, 1), ("data", "model"), [device])


def mesh_chips(mesh: Mesh) -> int:
    """Entries of the mesh (a repeated device counts each time)."""
    return mesh.size
