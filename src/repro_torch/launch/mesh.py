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

FSDP (``FSDP_TP``: weights split over ``data`` as well as ``model``):
:func:`gather_entry` gives one mesh entry its view of a leaf, one layer
at a time -- its own block of every dimension split over ``model``,
the ``data`` shards put back together -- and :func:`reduce_scatter`
sums the entries' gradients of their views onto the leaf's shards, in
entry order (data order, then model) in float32, rounded once, as
:func:`psum` sums partial outputs.  The gradient is routed by hand, not
by autograd: :class:`ShardGrads` takes each view through an autograd
node (:func:`entry_view`) whose backward hands the view's gradient back
to it, and reduce-scatters under ``no_grad`` once every entry that took
a view of that (leaf, layer) has handed its gradient in.  Autograd
would add the entries' gradients into the shard in its own order and
in the leaf's dtype; by hand the sum has one order and one rounding,
so a step repeats bit for bit.

The reference's TPU roofline constants have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import itertools
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
    (dicts, lists, tuples, named tuples and dataclasses such as
    ``GraphBatch``), the same tree structure in ``rest``.  A ``None``
    leaf (a ``GraphBatch`` without positions) and a dataclass's ``int``
    fields (``n_node``, ``n_graph``) are kept as they are."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest),
                              path=f"{path}{f.name}.")
            for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), int)})
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


# -------------------------------------------------------------------------
# FSDP: each entry's view of a leaf gathered over "data", and the views'
# gradients reduce-scattered back onto the leaf's shards
# -------------------------------------------------------------------------
def entry_coords(mesh: Mesh, entry: int) -> Dict[str, int]:
    """The coordinates of mesh entry ``entry`` (row-major)."""
    return dict(zip(mesh.axis_names, (int(i) for i in np.unravel_index(
        entry, mesh.devices.shape))))


def entry_bounds(placed: Placed, entry: int) -> Tuple[Tuple[int, int], ...]:
    """Per dimension, the ``[lo, hi)`` rows of mesh entry ``entry``'s
    view of ``placed``: a dimension split over ``"data"`` whole (FSDP
    gathers it), one split over another axis the entry's own block of
    it.  A dimension split over ``"data"`` together with another axis
    raises ``ValueError``: no rule table lays a weight out so."""
    sh, ndim = placed.sharding, len(placed.shape)
    bounds = placed.bounds(sh.block_of(entry_coords(sh.mesh, entry), ndim))
    out = []
    for i, e in enumerate(tuple(sh.spec) + (None,) * (ndim - len(sh.spec))):
        axes = _axes_of(e)
        if "data" not in axes:
            out.append(bounds[i])
        elif axes == ("data",):
            out.append((0, placed.shape[i]))
        else:
            raise ValueError(f"dimension {i} is split over {axes}: FSDP "
                             f"gathers a dimension split over 'data' alone")
    return tuple(out)


def _within(inner, outer) -> tuple:
    """Slices of the rows ``inner`` (bounds) relative to ``outer``."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(inner, outer))


def _layer_bounds(bounds, layer):
    return bounds if layer is None else ((layer, layer + 1),) + bounds[1:]


def gather_entry(placed: Placed, entry: int, layer: int | None = None,
                 device=None) -> torch.Tensor:
    """FSDP's all-gather: mesh entry ``entry``'s view of ``placed``
    (:func:`entry_bounds`: its blocks of the dimensions split over
    ``"model"``, the ``"data"`` shards put back together in order) as a
    tensor of its own on ``device`` (default: the entry's).  With
    ``layer``, index ``layer`` of the leading dimension only (the LM's
    stacked layers): one layer at a time."""
    bounds = entry_bounds(placed, entry)
    dev = canonical_device(device if device is not None else
                           placed.sharding.mesh.devices.flat[entry])
    key = placed.entry_keys[entry]
    if placed.bounds(key[0]) == bounds and (
            layer is None or bounds[0] == (0, placed.shape[0])):
        # the entry's own shard is its view (a leaf not split over
        # "data", a replicated one): copied from where the entry holds it
        own = placed.shards[key]
        return (own if layer is None else own[layer]).to(dev, copy=True)
    view = _layer_bounds(bounds, layer)
    shape = [hi - lo for lo, hi in view][0 if layer is None else 1:]
    out = torch.empty(shape, dtype=placed.dtype, device=dev)
    for _, bounds, shard in placed.blocks:
        inner = tuple((max(a, c), min(b, d))
                      for (a, b), (c, d) in zip(bounds, view))
        if any(hi <= lo for lo, hi in inner):
            continue
        src = shard[_within(inner, bounds)]
        dst = _within(inner, view)
        if layer is not None:
            src, dst = src[0], dst[1:]
        out[dst] = src.to(dev)
    return out


def reduce_scatter(placed: Placed, parts: Mapping[int, torch.Tensor],
                   layer: int | None = None) -> Dict[tuple, torch.Tensor]:
    """FSDP's reduce-scatter: ``parts`` are the gradients of mesh entries'
    views of ``placed`` (``{entry: tensor}``, each of the shape
    :func:`gather_entry` gives).  Each (block, device) shard of
    ``placed`` gets the sum of the views that hold its block, each sliced
    to it, added in entry order -- data order, then model -- in float32
    and rounded once (:func:`psum`), so the result is the same on every
    run.  With ``layer``, the shards' index ``layer`` of the leading
    dimension.  A shard that no view holds gets zeros."""
    views = {e: _layer_bounds(entry_bounds(placed, e), layer)
             for e in sorted(parts)}
    out = {}
    for key, shard in placed.shards.items():
        bounds = _layer_bounds(placed.bounds(key[0]), layer)
        got = []
        for e, view in views.items():
            if all(c <= a and b <= d for (a, b), (c, d) in zip(bounds, view)):
                sl = _within(bounds, view)
                got.append(parts[e][sl if layer is None else sl[1:]])
        out[key] = psum(got, key[1]) if got else torch.zeros(
            shard.shape[0 if layer is None else 1:], dtype=shard.dtype,
            device=key[1])
    return out


class _GatherView(torch.autograd.Function):
    """:func:`gather_entry` as a node of the autograd graph: its backward
    hands the view's gradient to the :class:`ShardGrads` that took it
    (the gradient is routed by hand) and passes nothing on."""

    @staticmethod
    def forward(ctx, anchor, grads, placed, entry, layer):
        ctx.taken = (grads, placed, entry, layer)
        return gather_entry(placed, entry, layer)

    @staticmethod
    def backward(ctx, grad):
        grads, placed, entry, layer = ctx.taken
        grads._arrive(placed, entry, layer, grad)
        return None, None, None, None, None


_GRAD_SINKS: list = []


class ShardGrads:
    """The gradients of a tree of :class:`Placed` leaves under FSDP,
    laid out as the leaves are.

    Inside ``with ShardGrads(device) as grads:`` the model code takes
    each mesh entry's view of a leaf by :func:`entry_view` (a gather,
    one layer at a time), and a backward from a loss to ``grads.anchor``
    (``torch.autograd.grad``) hands each view's gradient back here.  A
    view's gradient never reaches the leaf through autograd, which would
    add the entries' gradients in its own order and in the leaf's
    dtype: it is routed by hand.  Once every entry that took a view of a
    (leaf, layer) has handed in its gradient, they are reduce-scattered
    onto the leaf's shards (:func:`reduce_scatter`: in entry order, in
    float32) and dropped; :meth:`result` reduces what is left (views
    that reached no loss) and gives each leaf its gradient as a
    :class:`Placed` of the leaf's sharding, zeros where no view was
    taken.  An entry's view of a (leaf, layer) is taken once a forward;
    a second gradient for it raises ``RuntimeError``.  ``remat``'s
    recomputation takes the views again, which changes nothing here.

    On distinct cards autograd runs each device's backward on a thread
    of its own, so views' gradients arrive concurrently: each arrival
    counts itself on the key's ``itertools.count`` (``next`` on it is
    atomic), and the one that brings the count to the views taken
    reduces; the shards of a stacked leaf are allocated at its first
    view, in the forward, and each reduce writes its own layer."""

    def __init__(self, device) -> None:
        self.anchor = torch.zeros((), device=canonical_device(device),
                                  requires_grad=True)
        self._taken: dict = {}      # (id(leaf), layer) -> entries
        self._got: dict = {}        # (id(leaf), layer) -> {entry: grad}
        self._count: dict = {}      # (id(leaf), layer) -> arrivals
        self._done: set = set()
        self._shards: dict = {}     # id(leaf) -> (leaf, {key: grad})

    def __enter__(self) -> "ShardGrads":
        _GRAD_SINKS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _GRAD_SINKS.remove(self)

    def view(self, placed: Placed, entry: int,
             layer: int | None = None) -> torch.Tensor:
        """Mesh entry ``entry``'s view of ``placed`` (:func:`gather_entry`)
        whose gradient comes back here."""
        self._taken.setdefault((id(placed), layer), set()).add(entry)
        if id(placed) not in self._shards:
            self._shards[id(placed)] = (placed, {} if layer is None else {
                key: torch.zeros_like(t) for key, t in placed.shards.items()})
        return _GatherView.apply(self.anchor, self, placed, entry, layer)

    def _arrive(self, placed, entry, layer, grad) -> None:
        k = (id(placed), layer)
        got = self._got.setdefault(k, {})
        if k in self._done or entry in got:
            raise RuntimeError(f"entry {entry}'s view of a leaf of shape "
                               f"{placed.shape} (layer {layer}) was taken "
                               f"twice in one forward")
        got[entry] = grad
        if next(self._count.setdefault(k, itertools.count(1))) == \
                len(self._taken[k]):
            self._reduce(k)

    @torch.no_grad()
    def _reduce(self, k) -> None:
        parts = self._got.pop(k)
        self._done.add(k)
        placed, shards = self._shards[k[0]]
        layer = k[1]
        for key, g in reduce_scatter(placed, parts, layer).items():
            if layer is None:
                shards[key] = g
            else:
                shards[key][layer] = g

    @torch.no_grad()
    def result(self, tree):
        """``tree``'s leaves' gradients, each a :class:`Placed` of the
        leaf's sharding (module doc)."""
        for k in list(self._got):
            self._reduce(k)

        def grad(_, x):
            shards = self._shards.get(id(x), (x, {}))[1]
            return Placed(x.sharding, x.shape, x.dtype,
                          {key: shards[key] if key in shards else
                           torch.zeros_like(t)
                           for key, t in x.shards.items()}, x.entry_keys)
        return _tree_map(grad, tree)


def entry_view(placed: Placed, entry: int,
               layer: int | None = None) -> torch.Tensor:
    """Mesh entry ``entry``'s view of ``placed``, one layer at a time with
    ``layer``: inside a :class:`ShardGrads` context taken through it (its
    gradient routed back there), else a plain :func:`gather_entry`."""
    if _GRAD_SINKS:
        return _GRAD_SINKS[-1].view(placed, entry, layer)
    return gather_entry(placed, entry, layer)


def entry_views(tree, entry: int, layer: int | None = None):
    """:func:`entry_view` over every :class:`Placed` leaf of ``tree``."""
    return _tree_map(lambda _, x: entry_view(x, entry, layer), tree)


def entry_grid(mesh: Mesh) -> list:
    """The mesh's entries as FSDP reads them: one row per ``"data"``
    index, in order, each ``[(entry, device), ...]`` over the
    ``"model"`` indices in order (an axis the mesh lacks counts as size
    1).  Raises ``ValueError`` on any other axis."""
    other = set(mesh.axis_names) - {"data", "model"}
    if other:
        raise ValueError(f"FSDP runs on ('data', 'model') meshes; this one "
                         f"has {sorted(other)} too")
    shape = mesh.shape
    grid = [[None] * shape.get("model", 1) for _ in range(shape.get(
        "data", 1))]
    for e, dev in enumerate(mesh.devices.flat):
        c = entry_coords(mesh, e)
        grid[c.get("data", 0)][c.get("model", 0)] = (e, dev)
    return grid
