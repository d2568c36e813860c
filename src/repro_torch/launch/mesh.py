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

Tensors are laid out over a mesh as ``jax.sharding`` lays them out:
:class:`PartitionSpec` names, for each dimension, the mesh axes it is
split over (``None``: not split), :class:`NamedSharding` pairs it with
a mesh, and :func:`place` cuts a tensor into a :class:`Placed` -- one
contiguous shard per distinct (block, device) pair, each on its
entry's device -- which :func:`gather` puts back together.  A
dimension split ``p`` ways that ``p`` does not divide gets shards of
``ceil(n / p)`` rows, the last ones shorter (possibly empty).

The reference's TPU roofline constants have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Iterator, Mapping, Sequence, \
    Tuple

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


# -------------------------------------------------------------------------
# Partition specs and placed tensors
# -------------------------------------------------------------------------
class PartitionSpec(tuple):
    """The mesh axes each dimension is split over (the counterpart of
    ``jax.sharding.PartitionSpec``): an entry is ``None`` (not split),
    an axis name, or a tuple of axis names (split over their product,
    row-major).  Trailing dimensions without an entry are not split.
    Hashable and comparable; ``PartitionSpec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh` (the counterpart of
    ``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self) -> None:
        used = [a for e in self.spec for a in _axes_of(e)]
        bad = [a for a in used if a not in self.mesh.axis_names]
        if bad or len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} does not fit the mesh axes "
                             f"{self.mesh.axis_names}")

    def parts(self, ndim: int) -> Tuple[int, ...]:
        """How many ways each of ``ndim`` dimensions is split."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dimensions")
        shape = self.mesh.shape
        return tuple(math.prod(shape[a] for a in _axes_of(e))
                     for e in self.spec) + (1,) * (ndim - len(self.spec))

    def block_of(self, coords: Mapping[str, int], ndim: int) -> tuple:
        """The block an entry at mesh ``coords`` holds: per dimension,
        the row-major index of its coordinates along that dimension's
        axes."""
        shape = self.mesh.shape
        out = []
        for e in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            i = 0
            for a in _axes_of(e):
                i = i * shape[a] + coords[a]
            out.append(i)
        return tuple(out)

    def entries(self) -> Iterator[Tuple[Dict[str, int], torch.device]]:
        """Each mesh entry's coordinates and device, in row-major order."""
        names = self.mesh.axis_names
        for idx in np.ndindex(*self.mesh.devices.shape):
            yield dict(zip(names, idx)), self.mesh.devices[idx]


def block_bounds(shape: Sequence[int], parts: Sequence[int],
                 block: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Per dimension, the ``[lo, hi)`` rows of ``block``: shards of
    ``ceil(n / p)`` rows, the last ones shorter (possibly empty)."""
    out = []
    for n, p, i in zip(shape, parts, block):
        step = -(-n // p)
        out.append((min(i * step, n), min((i + 1) * step, n)))
    return tuple(out)


class Placed:
    """A tensor laid out over a mesh by a :class:`NamedSharding`.

    ``shards`` maps each distinct (block, device) pair to its own
    contiguous tensor on that device: entries that hold the same block
    on one device share one shard (one copy per *distinct* device).
    ``blocks`` lists each block once, in the mesh order of its first
    entry, with its bounds and the shard on that entry's device."""

    __slots__ = ("sharding", "shape", "dtype", "shards", "entry_keys")

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 shards: Dict[tuple, torch.Tensor],
                 entry_keys: Tuple[tuple, ...]) -> None:
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards
        self.entry_keys = entry_keys       # (block, device) per entry

    @property
    def parts(self) -> Tuple[int, ...]:
        return self.sharding.parts(len(self.shape))

    def bounds(self, block: tuple) -> Tuple[Tuple[int, int], ...]:
        return block_bounds(self.shape, self.parts, block)

    @property
    def blocks(self) -> Tuple[Tuple[tuple, tuple, torch.Tensor], ...]:
        """((block, device), bounds, shard) once per block, in the mesh
        order of its first entry, which holds that shard."""
        seen = {}
        for block, dev in self.entry_keys:
            if block not in seen:
                seen[block] = ((block, dev), self.bounds(block),
                               self.shards[(block, dev)])
        return tuple(seen.values())

    def shard(self, entry: int) -> torch.Tensor:
        """The shard mesh entry ``entry`` (row-major) holds."""
        return self.shards[self.entry_keys[entry]]

    def map(self, fn: Callable[[torch.Tensor, tuple, torch.device],
                               torch.Tensor]) -> "Placed":
        """A placed tensor of the same layout whose shards are
        ``fn(shard, slices, device)``: ``slices`` index the shard's
        block in the whole tensor.  ``fn`` keeps each shard's shape (a
        norm, a residual add)."""
        return Placed(self.sharding, self.shape, self.dtype,
                      {key: fn(t, _slices(self.bounds(key[0])), key[1])
                       for key, t in self.shards.items()}, self.entry_keys)

    def nbytes_by_device(self) -> Dict[torch.device, int]:
        """Bytes of shards held on each device."""
        out: Dict[torch.device, int] = {}
        for (_, dev), t in self.shards.items():
            out[dev] = out.get(dev, 0) + t.numel() * t.element_size()
        return out

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, shards={len(self.shards)})")


def _layout(shape, dtype, sharding: NamedSharding,
            make: Callable[[tuple, torch.device], torch.Tensor]) -> Placed:
    ndim = len(shape)
    parts = sharding.parts(ndim)
    shards: Dict[tuple, torch.Tensor] = {}
    keys = []
    for coords, dev in sharding.entries():
        block = sharding.block_of(coords, ndim)
        key = (block, dev)
        if key not in shards:
            shards[key] = make(block_bounds(shape, parts, block), dev)
        keys.append(key)
    return Placed(sharding, shape, dtype, shards, tuple(keys))


def _slices(bounds) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in bounds)


def place(tensor: torch.Tensor, sharding: NamedSharding) -> Placed:
    """``tensor`` cut into the blocks ``sharding`` names, each copied
    once to each distinct device that holds it, as a contiguous tensor
    of its own (never a view of ``tensor``)."""
    def make(bounds, dev):
        part = tensor[_slices(bounds)]
        return torch.empty(part.shape, dtype=tensor.dtype,
                           device=dev).copy_(part)
    return _layout(tuple(tensor.shape), tensor.dtype, sharding, make)


def place_zeros(shape, dtype, sharding: NamedSharding) -> Placed:
    """A zero tensor of ``shape`` laid out as :func:`place` lays it out,
    made shard by shard (no whole tensor is ever allocated)."""
    return _layout(tuple(shape), dtype, sharding, lambda bounds, dev:
                   torch.zeros([hi - lo for lo, hi in bounds],
                               dtype=dtype, device=dev))


def gather(placed: Placed, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the first entry's), each
    block read once."""
    if device is None:
        device = placed.entry_keys[0][1]
    out = torch.empty(placed.shape, dtype=placed.dtype,
                      device=canonical_device(device))
    for _, bounds, shard in placed.blocks:
        out[_slices(bounds)] = shard.to(out.device)
    return out


# -------------------------------------------------------------------------
# Trees of placed tensors, and the collectives one controller runs
# -------------------------------------------------------------------------
def _tree_map(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over the tensor leaves of ``tree``
    (dicts, lists, tuples and named tuples), the same tree structure in
    ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest),
                             path=f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest), path=f"{path}{i}.")
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(path[:-1], tree, *rest)


def place_tree(tree, shardings, specs=None):
    """Each tensor of ``tree`` placed (:func:`place`) by the
    :class:`NamedSharding` at the same place of ``shardings`` (a tree of
    the same structure: ``sharding.resolve_tree``'s output).

    A split dimension must split evenly: one the axes' size does not
    divide raises ``ValueError`` naming the leaf, the dimension and, with
    ``specs`` (the logical spec tree the shardings were resolved from),
    its logical name.  A leaf already placed by its sharding is kept, one
    placed by another is gathered and placed anew.  ``tree`` may hold
    meta tensors: their placed shards are meta tensors too, and nothing
    is allocated."""
    def one(path, x, sh, *spec):
        if isinstance(x, Placed) and x.sharding == sh:
            return x
        parts = sh.parts(len(x.shape))
        for i, (n, p) in enumerate(zip(x.shape, parts)):
            if n % p:
                name = f" ({spec[0][i]})" if spec and spec[0] else ""
                raise ValueError(
                    f"{path}: dimension {i}{name} of size {n} does not "
                    f"split evenly over {p} mesh entries")
        return place(gather(x) if isinstance(x, Placed) else x, sh)
    rest = (shardings,) if specs is None else (shardings, specs)
    return _tree_map(one, tree, *rest)


def local_tree(tree, entry: int):
    """The tensors mesh entry ``entry`` (row-major) holds of a tree of
    :class:`Placed` leaves: each its shard; a whole tensor stays as it
    is."""
    return _tree_map(lambda _, x: x.shard(entry) if isinstance(x, Placed)
                     else x, tree)


def psum(parts, device) -> torch.Tensor:
    """The entries' partial outputs summed in entry order on ``device``
    (the reference's ``psum``): in float32, or wider where the parts are,
    rounded once to the parts' dtype, so the result is the same on every
    run."""
    acc = torch.promote_types(parts[0].dtype, torch.float32)
    out = parts[0].to(device, acc)
    for p in parts[1:]:
        out = out + p.to(device, acc)
    return out.to(parts[0].dtype)


def all_gather(parts, dim: int, device) -> torch.Tensor:
    """Split outputs put back together in entry order along ``dim`` on
    ``device`` (logit columns over ``vocab``, contexts over ``heads``)."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
