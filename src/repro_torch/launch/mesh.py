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

Dry runs (``launch.dryrun``): the H100's roofline constants
(:data:`PEAK_FLOPS_BF16`, :data:`HBM_BW`, :data:`NVLINK_BW`,
:data:`NET_BW`) replace the reference's TPU v5e ones, and a
:class:`Tally`, while one is active (:func:`counting`), takes what a
step does entry by entry.  The loops that run an entry's work enter it
(:func:`working`); work outside every entry is the controller's, entry
0.  In a dry run, entries whose work has the same shapes run it once
for all of them (:func:`alike`: a production mesh's 256 entries would
otherwise run every layer 256 times in Python), and that work is
charged to each.  The collectives below (:func:`place`, :func:`gather`,
:func:`psum`, :func:`all_gather`, :func:`gather_entry`,
:func:`reduce_scatter`) charge the bytes they move from entry to entry
(:meth:`Tally.move`, by entry, not by device: on a meta mesh every
entry is the same device) and the bytes they read and write; their own
tensor ops are not counted op by op, and on the meta device they make
their outputs without copying anything.  Outside a dry run all of this
costs one attribute read (``_TALLY``), on the card as on meta.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import weakref
from typing import Callable, Dict, Iterable, Iterator, Mapping, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core.graph import resolve_device

# -------------------------------------------------------------------------
# The H100's roofline constants (NVIDIA H100 SXM data sheet: dense rates
# without sparsity, at the 700 W power limit; HGX / DGX H100 system
# specifications for the links)
# -------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 989e12       # FLOP/s a GPU, bf16 tensor cores, dense
HBM_BW = 3.35e12               # bytes/s a GPU
NVLINK_BW = 450e9              # bytes/s a GPU each way: NVLink 4, 900 GB/s
                               # in all, within an 8-GPU HGX node
NET_BW = 50e9                  # bytes/s a GPU each way between nodes: one
                               # 400 Gb/s NIC a GPU (DGX H100)
#: GPUs a node: mesh entries e and e' (row-major) share one when
#: ``e // NODE_GPUS == e' // NODE_GPUS``.
NODE_GPUS = 8

#: The active :class:`Tally` (``None`` outside a dry run).
_TALLY = None


class Tally:
    """What one dry run counts over a mesh of ``n`` entries: per entry
    the FLOPs, the HBM bytes, the live and peak bytes of the tensors the
    step makes, and the bytes each collective moves in and out, over
    NVLink (both entries in one node) or the network; summed over the
    entries, FLOPs, bytes and counts by op.

    ``work`` is the entries the running code works for and how many
    times (``(entries, times)``); :meth:`charge` adds an op's FLOPs and
    bytes to each of them ``times`` times."""

    def __init__(self, n: int, alike: bool = False,
                 host_skip: bool = False) -> None:
        self.n = n
        self.alike = alike
        self.host_skip = host_skip  # collectives.counted
        self.node = np.arange(n) // NODE_GPUS
        self.base = (np.zeros(1, dtype=np.int64), 1)
        self.work = self.base
        self.peers = None           # entries of the rows a row stands for
        self.stack: list = []       # works the backward's nodes entered
        self.quiet = 0
        self.flops, self.bytes = np.zeros(n), np.zeros(n)
        self.live, self.peak = np.zeros(n), np.zeros(n)
        self.link = {k: (np.zeros(n), np.zeros(n)) for k in ("nvlink",
                                                              "net")}
        self.flops_by_op: Dict[str, float] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.ops: Dict[str, int] = {}
        self.moved: Dict[str, tuple] = {}      # op -> (in, out) an entry
        self.calls: Dict[str, int] = {}
        self.ring: Dict[str, float] = {}       # op -> ring-estimate bytes
        self.owners: dict = {}                 # storage -> [entries, refs,
                                               # bytes]
        self.geometry: dict = {}               # (sharding, shape) -> ...

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """One op of ``flops`` and ``nbytes`` on each working entry."""
        entries, times = self.work
        self.flops[entries] += flops * times
        self.bytes[entries] += nbytes * times
        k = len(entries) * times
        self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + flops * k
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes * k
        self.ops[name] = self.ops.get(name, 0) + k

    def move(self, op: str, src, dst, nbytes) -> None:
        """``nbytes`` from entries ``src`` to entries ``dst`` (arrays of
        one length, or scalars): the sender reads them and the receiver
        writes them (HBM bytes, under ``op``); between two entries they
        also cross a link.  An entry's move to itself is a local copy."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int64))
        src, dst = np.broadcast_arrays(src, dst)
        nb = np.broadcast_to(np.asarray(nbytes, dtype=np.float64), src.shape)
        np.add.at(self.bytes, src, nb)
        np.add.at(self.bytes, dst, nb)
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + 2 * nb.sum()
        far = src != dst
        src, dst, nb = src[far], dst[far], nb[far]
        if not len(src):
            return
        into, out = self.moved.setdefault(op, (np.zeros(self.n),
                                               np.zeros(self.n)))
        np.add.at(into, dst, nb)
        np.add.at(out, src, nb)
        near = self.node[src] == self.node[dst]
        for kind, m in (("nvlink", near), ("net", ~near)):
            np.add.at(self.link[kind][0], dst[m], nb[m])
            np.add.at(self.link[kind][1], src[m], nb[m])

    def call(self, op: str, kind: str, result_bytes: float, k: int) -> None:
        """One call of collective ``op``, whose ring-algorithm counterpart
        is ``kind`` over ``k`` entries with a result of ``result_bytes``
        (``launch.collectives.ring_wire_bytes``)."""
        from repro_torch.launch.collectives import ring_wire_bytes
        self.calls[op] = self.calls.get(op, 0) + 1
        self.ring[op] = self.ring.get(op, 0.0) + ring_wire_bytes(
            kind, result_bytes, k)

    def owner(self, x: torch.Tensor):
        """The entries the step made ``x``'s storage for (entry 0 for a
        tensor it did not make)."""
        got = self.owners.get(_storage_key(x))
        return got[0] if got is not None else self.base[0]

    def made(self, x: torch.Tensor, fresh: bool) -> None:
        """``x`` came out of an op: a new storage (``fresh``) is live on
        the working entries until its last tensor seen here is freed."""
        key = _storage_key(x)
        got = self.owners.get(key)
        if got is None:
            if not fresh:
                return
            entries = self.work[0]
            nbytes = x.untyped_storage().nbytes()
            got = self.owners[key] = [entries, 0, nbytes]
            self.live[entries] += nbytes
            self.peak[entries] = np.maximum(self.peak[entries],
                                            self.live[entries])
        got[1] += 1
        weakref.finalize(x, self._drop, key)

    def _drop(self, key) -> None:
        got = self.owners.get(key)
        if got is None:
            return
        got[1] -= 1
        if got[1] == 0:
            del self.owners[key]
            self.live[got[0]] -= got[2]


def _storage_key(x: torch.Tensor) -> int:
    return x.untyped_storage()._cdata


@contextlib.contextmanager
def counting(n: int, alike: bool = False, host_skip: bool = False):
    """A :class:`Tally` of ``n`` entries active for the block (dry runs
    do not nest).  With ``alike`` (a dry run on the meta device, where
    no value is read) entries whose work is alike run it once for all
    (:func:`alike`, :func:`collapsing`); without it every entry runs its
    own, and the step's outputs are its true ones.  ``host_skip``:
    ``launch.collectives.counted``."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("a dry run is already counting")
    _TALLY = Tally(n, alike, host_skip)
    try:
        yield _TALLY
    finally:
        _TALLY = None


class _Working:
    __slots__ = ("work", "prev")

    def __init__(self, entries, times: int) -> None:
        self.work = (np.atleast_1d(np.asarray(entries, dtype=np.int64)),
                     int(times))

    def __enter__(self):
        self.prev = _TALLY.work
        _TALLY.work = self.work
        return self

    def __exit__(self, *exc) -> None:
        _TALLY.work = self.prev


_IDLE = contextlib.nullcontext()


def working(entries, times: int = 1):
    """The block is the work of mesh entry (or entries) ``entries``,
    each ``times`` times (:class:`Tally`); nothing outside a dry run."""
    if _TALLY is None:
        return _IDLE
    return _Working(entries, times)


def as_controller(fn):
    """``fn`` run as the controller's work (entry 0).  Under remat the
    engine recomputes a checkpointed function inside the backward of the
    node that needs it, whose work is then running; this keeps the
    recomputation's own work where its forward was."""
    def run(*args, **kwargs):
        with working(0):
            return fn(*args, **kwargs)
    return run


def collapsing() -> bool:
    """Whether alike entries run their work once (:func:`counting`)."""
    return _TALLY is not None and _TALLY.alike


def alike(keys: Sequence) -> list:
    """Which items of a loop over entries to run: ``[(i, (i, j, ...)),
    ...]``, item ``i`` standing for itself and the items ``j`` after it
    with an equal key (their work has the same shapes).  Outside a dry
    run on the meta device every item stands alone."""
    if not collapsing():
        return [(i, (i,)) for i in range(len(keys))]
    first: dict = {}
    for i, k in enumerate(keys):
        first.setdefault(k, []).append(i)
    return [(same[0], tuple(same)) for same in first.values()]


def each_entry(ents, fn) -> list:
    """``[fn(i, dev, p, e) for i, (dev, p, e) in enumerate(ents)]`` over a
    row of mesh entries (``p`` an entry's weights, ``e`` its index), each
    call in its entry's work (:func:`working`).  In a dry run the
    entries that share one ``p`` object (:func:`row_groups`) call ``fn``
    once, for all of them (and for the entries at their places in the
    rows the running row stands for: :func:`each_row`), and its output
    stands for each."""
    outs = [None] * len(ents)
    peers = _TALLY.peers if _TALLY is not None else None
    for i, same in alike([id(p) for _, p, _ in ents]):
        dev, p, e = ents[i]
        here = [ents[j][2] for j in same] if not peers else \
            [row[j] for row in peers for j in same]
        with working(here):
            out = fn(i, dev, p, e)
        for j in same:
            outs[j] = out
    return outs


def row_groups(rows, view) -> list:
    """``[(b0, b1, [(dev, view(e), e) for e, dev in row]) for b0, b1, row
    in rows]``: each entry's weights (``view`` gathers or slices them).

    In a dry run on the meta device a row of a size seen before carries
    no weights (``None``; :func:`each_row` runs the first such row for
    it), and within a row the entries after the first share the
    second's view object (:func:`each_entry` runs their work once).  A
    view is taken once, in the work of every entry it stands for (the
    moves of each one's view charged: :func:`gather_entry`).  The
    weights are split evenly over ``model`` (``check_tp``,
    ``check_fsdp``), so those views have one shape; the first entry
    stays apart for the work only it does (the new K and V rows, the
    router)."""
    if not collapsing():
        return [(b0, b1, [(dev, view(e), e) for e, dev in row])
                for b0, b1, row in rows]
    out = [None] * len(rows)
    for i, same in alike([b1 - b0 for b0, b1, _ in rows]):
        b0, b1, row = rows[i]
        peers = [rows[j][2] for j in same]
        with working([r[0][0] for r in peers]):
            ents = [(row[0][1], view(row[0][0]), row[0][0])]
        if len(row) > 1:
            with working([e for r in peers for e, _ in r[1:]]):
                shared = view(row[1][0])
            ents += [(dev, shared, e) for e, dev in row[1:]]
        out[i] = (b0, b1, ents)
        for j in same[1:]:
            out[j] = (rows[j][0], rows[j][1],
                      [(dev, None, e) for e, dev in rows[j][2]])
    return out


def each_row(groups, fn) -> list:
    """``[fn(i, b0, b1, ents) for i, (b0, b1, ents) in enumerate(groups)]``
    over the rows :func:`row_groups` gives.  In a dry run a row that
    carries no weights takes the output of the row before it of its
    size, whose work stands for both (its entries' work charged to the
    entries at the same places of every row it stands for, its
    collectives' moves once for each row: :func:`each_entry`,
    :func:`collect`)."""
    outs = [None] * len(groups)
    for i, (b0, b1, ents) in enumerate(groups):
        if ents[0][1] is None:
            continue
        stand = [i] + [j for j in range(i + 1, len(groups))
                       if groups[j][2][0][1] is None
                       and groups[j][1] - groups[j][0] == b1 - b0]
        t = _TALLY
        if t is not None and len(stand) > 1:
            t.peers = [[e for _, _, e in groups[j][2]] for j in stand]
        try:
            out = fn(i, b0, b1, ents)
        finally:
            if t is not None:
                t.peers = None
        for j in stand:
            if outs[j] is None:
                outs[j] = out
    return outs


def _is_meta(x) -> bool:
    return x.device.type == "meta"


class _Geometry:
    """How a (sharding, shape) lays blocks over a mesh's entries, for
    the collectives' charges: each entry's block, each block's bounds
    and the entries that hold it."""

    def __init__(self, sharding: NamedSharding, shape) -> None:
        ndim = len(shape)
        parts = sharding.parts(ndim)
        index: dict = {}
        blk, bounds, holders = [], [], []
        for e, (coords, _) in enumerate(sharding.entries()):
            b = sharding.block_of(coords, ndim)
            if b not in index:
                index[b] = len(bounds)
                bounds.append(block_bounds(shape, parts, b))
                holders.append([])
            blk.append(index[b])
            holders[index[b]].append(e)
        self.coords = np.stack(np.unravel_index(
            np.arange(len(blk)), sharding.mesh.devices.shape), axis=1)
        self.blk = np.asarray(blk, dtype=np.int64)
        self.bounds = np.asarray(bounds, dtype=np.int64).reshape(
            len(bounds), ndim, 2)
        self.holders = [np.asarray(h, dtype=np.int64) for h in holders]
        data = [i for i, e in enumerate(tuple(sharding.spec) + (None,) * (
            ndim - len(sharding.spec))) if "data" in _axes_of(e)]
        self.views = self.bounds[self.blk].copy()   # entry -> view bounds
        for i in data:
            self.views[:, i] = (0, shape[i])
        self.cache: dict = {}

    def nearest(self, b: int, e: int, node) -> int:
        """The holder of block ``b`` nearest entry ``e``: ``e`` itself,
        else one in its node, then the one whose mesh coordinates differ
        from ``e``'s on the fewest axes (an all-gather along one axis),
        then the closest in mesh order."""
        h = self.holders[b]
        axes = (self.coords[h] != self.coords[e]).sum(axis=1)
        return int(h[np.lexsort((np.abs(h - e), axes,
                                 node[h] != node[e]))[0]])


def _geometry(t: Tally, sharding: NamedSharding, shape) -> _Geometry:
    key = (sharding, tuple(shape))
    g = t.geometry.get(key)
    if g is None:
        g = t.geometry[key] = _Geometry(sharding, shape)
    return g


def _volume(bounds) -> np.ndarray:
    return np.prod(np.maximum(bounds[..., 1] - bounds[..., 0], 0), axis=-1)


def _layered(bounds, layer):
    if layer is None:
        return bounds
    out = bounds.copy()
    out[..., 0, :] = (layer, layer + 1)
    return out


def _counting():
    """The active tally, unless the running code is a collective's own
    (:func:`_quiet`)."""
    t = _TALLY
    return None if t is None or t.quiet else t


def collect(op: str, kind: str, parts, dst=None) -> None:
    """Charge ``parts`` brought into entry ``dst`` (default: the first
    working one) from the entries that made them (:meth:`Tally.owner`;
    a tensor listed ``k`` times stands for the first ``k`` of its
    owners), as one call of ``op`` (``kind``: its ring counterpart over
    ``len(parts)`` entries).  Nothing outside a dry run."""
    t = _counting()
    if t is None:
        return
    dst = int(t.work[0][0]) if dst is None else dst
    times: dict = {}
    for p in parts:
        times[id(p)] = times.get(id(p), 0) + 1
    for r in range(len(t.peers) if t.peers else 1):
        seen: dict = {}
        src, nb = [], []
        for p in parts:
            own = t.owner(p)
            i = seen[id(p)] = seen.get(id(p), -1) + 1
            src.append(int(own[(r * times[id(p)] + i) % len(own)]))
            nb.append(p.numel() * p.element_size())
        t.move(op, src, dst, nb)
        t.call(op, kind, nb[0] if kind == "all-reduce" else sum(nb),
               len(parts))


def count_move(op: str, kind: str, src, dst, nbytes) -> None:
    """Charge moves ``src`` -> ``dst`` of ``nbytes`` (arrays or scalars)
    a collective of the model code makes itself (the ring's block
    fetches; ``dst=None``: the working entries), as one call of ``op``.
    Nothing outside a dry run."""
    t = _counting()
    if t is None:
        return
    dst = t.work[0] if dst is None else dst
    t.move(op, src, dst, nbytes)
    t.call(op, kind, float(np.max(nbytes)), int(np.size(src)) + 1)


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

    def axis_entries(self, axes: Iterable[str]) -> Tuple[int, ...]:
        """The entries (row-major indices) :meth:`axis_devices` names."""
        axes = tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        idx = np.arange(self.size).reshape(self.devices.shape)
        moved = np.transpose(idx, pos + rest)
        grid = moved.reshape(math.prod(moved.shape[:len(pos)]), -1)
        return tuple(int(e) for e in grid[:, 0])


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
        holders: dict = {}
        for e, key in enumerate(self.entry_keys):
            holders.setdefault(key, []).append(e)
        keys = list(self.shards)
        shards = {}
        # each shard's work is its holders' (alike shards once in a dry
        # run on meta: alike)
        for i, same in alike([tuple(self.shards[k].shape) for k in keys]):
            key = keys[i]
            with working([e for j in same for e in holders[keys[j]]]):
                out = fn(self.shards[key], _slices(self.bounds(key[0])),
                         key[1])
            for j in same:
                shards[keys[j]] = out
        return Placed(self.sharding, self.shape, self.dtype, shards,
                      self.entry_keys)

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
    t = _counting()
    if t is not None:
        g = _geometry(t, sharding, tensor.shape)
        nb = _volume(g.bounds)[g.blk] * tensor.element_size()
        t.move("place", t.owner(tensor)[0], np.arange(t.n), nb)
        t.call("place", "all-to-all", tensor.numel() *
               tensor.element_size(), t.n)

    def make(bounds, dev):
        part = tensor[_slices(bounds)]
        return torch.empty(part.shape, dtype=tensor.dtype,
                           device=dev).copy_(part)
    with quiet():
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
    t = _counting()
    if t is not None:
        g = _geometry(t, placed.sharding, placed.shape)
        dst = int(t.work[0][0])
        src = [g.nearest(b, dst, t.node) for b in range(len(g.holders))]
        esize = placed.dtype.itemsize
        t.move("gather", src, dst, _volume(g.bounds) * esize)
        t.call("gather", "all-gather", math.prod(placed.shape) * esize,
               len(src))
    with quiet():
        out = torch.empty(placed.shape, dtype=placed.dtype,
                          device=canonical_device(device))
        for _, bounds, shard in placed.blocks:
            out[_slices(bounds)] = shard.to(out.device)
        return out


# -------------------------------------------------------------------------
# Trees of placed tensors, and the collectives one controller runs
# -------------------------------------------------------------------------
def map_tree(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over the tensor leaves of ``tree``
    (dicts, lists, tuples, named tuples and dataclasses such as
    ``GraphBatch``), the same tree structure in ``rest``.  A ``None``
    leaf (a ``GraphBatch`` without positions) and a dataclass's ``int``
    fields (``n_node``, ``n_graph``) are kept as they are."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest),
                             path=f"{path}{f.name}.")
            for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), int)})
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest),
                            path=f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, *(r[i] for r in rest), path=f"{path}{i}.")
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
    return map_tree(one, tree, *rest)


def local_tree(tree, entry: int):
    """The tensors mesh entry ``entry`` (row-major) holds of a tree of
    :class:`Placed` leaves: each its shard; a whole tensor stays as it
    is."""
    return map_tree(lambda _, x: x.shard(entry) if isinstance(x, Placed)
                     else x, tree)


def psum(parts, device) -> torch.Tensor:
    """The entries' partial outputs summed in entry order on ``device``
    (the reference's ``psum``): in float32, or wider where the parts are,
    rounded once to the parts' dtype, so the result is the same on every
    run."""
    collect("psum", "all-reduce", parts)
    with quiet():
        acc = torch.promote_types(parts[0].dtype, torch.float32)
        out = parts[0].to(device, acc)
        for p in parts[1:]:
            out = out + p.to(device, acc)
        return out.to(parts[0].dtype)


def all_gather(parts, dim: int, device) -> torch.Tensor:
    """Split outputs put back together in entry order along ``dim`` on
    ``device`` (logit columns over ``vocab``, contexts over ``heads``)."""
    collect("all_gather", "all-gather", parts)
    with quiet():
        return torch.cat([p.to(device) for p in parts], dim=dim)


def kernel_cost(name: str, flops: float, nbytes: float):
    """The block is one call of kernel ``name``: in a dry run it charges
    ``flops`` and ``nbytes`` to the working entries, whatever route the
    block takes (the card's kernel, its plain version, or outputs made
    on the meta device), and the block's own ops are not counted."""
    t = _counting()
    if t is None:
        return _IDLE
    t.charge(name, flops, nbytes)
    return _Quiet(t)


class _Quiet:
    __slots__ = ("t",)

    def __init__(self, t: Tally) -> None:
        self.t = t

    def __enter__(self):
        self.t.quiet += 1

    def __exit__(self, *exc) -> None:
        self.t.quiet -= 1


def quiet():
    """The block's tensor ops are a collective's, charged by formula,
    not op by op (module doc)."""
    return _IDLE if _TALLY is None else _Quiet(_TALLY)


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
    t = _counting()
    if t is not None:
        _charge_views(t, placed, entry, layer)
        if _is_meta(placed.shards[placed.entry_keys[entry]]):
            view = _layer_bounds(bounds, layer)
            with quiet(), _for_entry(entry):
                return torch.empty([hi - lo for lo, hi in view][
                    0 if layer is None else 1:], dtype=placed.dtype,
                    device=dev)
    with quiet(), _for_entry(entry):
        return _gather_entry(placed, entry, layer, bounds, dev)


def _for_entry(entry: int):
    """:func:`working` for ``entry`` unless the running work is already
    its (alike entries included)."""
    t = _TALLY
    if t is None or entry in t.work[0]:
        return _IDLE
    return working(entry)


def _charge_views(t: Tally, placed: Placed, entry: int, layer) -> None:
    """The moves of entry ``entry``'s view (:func:`gather_entry`), and of
    the views of the entries it works for alike (:func:`alike`)."""
    g = _geometry(t, placed.sharding, placed.shape)
    es = t.work[0] if entry in t.work[0] else [entry]
    esize = placed.dtype.itemsize
    for e in es:
        key = ("view", layer is None, int(e))
        got = g.cache.get(key)
        if got is None:
            view = _layered(g.views[e], 0 if layer is not None else None)
            blocks = _layered(g.bounds, 0 if layer is not None else None)
            lo = np.maximum(blocks[..., 0], view[..., 0])
            hi = np.minimum(blocks[..., 1], view[..., 1])
            vol = np.prod(np.maximum(hi - lo, 0), axis=-1)
            hit = np.nonzero(vol)[0]
            got = g.cache[key] = (
                np.asarray([g.nearest(b, int(e), t.node) for b in hit],
                           dtype=np.int64), vol[hit] * esize)
        t.move("gather_entry", got[0], int(e), got[1])
        t.call("gather_entry", "all-gather", float(got[1].sum()),
               len(got[0]))


def _gather_entry(placed: Placed, entry: int, layer, bounds, dev):
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
    t = _counting()
    if t is not None:
        _charge_reduce(t, placed, sorted(parts), layer)
        if _is_meta(next(iter(parts.values()))):
            with quiet():
                return {key: torch.empty(
                    shard.shape[0 if layer is None else 1:],
                    dtype=shard.dtype, device=key[1])
                    for key, shard in placed.shards.items()}
    with quiet():
        return _reduce_scatter(placed, parts, layer)


def _charge_reduce(t: Tally, placed: Placed, views, layer) -> None:
    """The moves of :func:`reduce_scatter`: each entry's block from every
    view that holds it."""
    g = _geometry(t, placed.sharding, placed.shape)
    key = ("reduce", layer is None, tuple(views))
    got = g.cache.get(key)
    if got is None:
        v = np.asarray(views, dtype=np.int64)
        blocks = _layered(g.bounds[g.blk], 0 if layer is not None else None)
        vb = _layered(g.views[v], 0 if layer is not None else None)
        holds = np.all((vb[None, :, :, 0] <= blocks[:, None, :, 0]) &
                       (blocks[:, None, :, 1] <= vb[None, :, :, 1]), axis=-1)
        dst, which = np.nonzero(holds)
        got = g.cache[key] = (v[which], dst, _volume(blocks)[dst] *
                              placed.dtype.itemsize)
    t.move("reduce_scatter", got[0], got[1], got[2])
    t.call("reduce_scatter", "reduce-scatter",
           float(got[2].max()) if len(got[2]) else 0.0, len(views))


def _reduce_scatter(placed: Placed, parts, layer):
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
        self._alike: dict = {}      # (id(leaf), layer, entry) -> entries
                                    # its view stands for (dry runs)

    def __enter__(self) -> "ShardGrads":
        _GRAD_SINKS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _GRAD_SINKS.remove(self)

    def view(self, placed: Placed, entry: int,
             layer: int | None = None) -> torch.Tensor:
        """Mesh entry ``entry``'s view of ``placed`` (:func:`gather_entry`)
        whose gradient comes back here."""
        t = _TALLY
        group = tuple(int(e) for e in t.work[0]) if t is not None and \
            entry in t.work[0] else (entry,)
        self._taken.setdefault((id(placed), layer), set()).update(group)
        self._alike[(id(placed), layer, entry)] = group
        if id(placed) not in self._shards:
            self._shards[id(placed)] = (placed, {} if layer is None else {
                key: torch.zeros_like(t) for key, t in placed.shards.items()})
        return _GatherView.apply(self.anchor, self, placed, entry, layer)

    def _arrive(self, placed, entry, layer, grad) -> None:
        k = (id(placed), layer)
        got = self._got.setdefault(k, {})
        count = self._count.setdefault(k, itertools.count(1))
        for e in self._alike.get(k + (entry,), (entry,)):
            if k in self._done or e in got:
                raise RuntimeError(f"entry {e}'s view of a leaf of shape "
                                   f"{placed.shape} (layer {layer}) was "
                                   f"taken twice in one forward")
            got[e] = grad
            if next(count) == len(self._taken[k]):
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
        return map_tree(grad, tree)


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
    return map_tree(lambda _, x: entry_view(x, entry, layer), tree)


def entry_grid(mesh: Mesh) -> list:
    """The mesh's entries as FSDP reads them: one row per ``"data"``
    index (per ``("pod", "data")`` pair on a mesh of pods: the batch's
    ``("pod", "data")`` blocks), in order, each ``[(entry, device), ...]``
    over the ``"model"`` indices in order (an axis the mesh lacks counts
    as size 1).  Raises ``ValueError`` on any other axis."""
    other = set(mesh.axis_names) - {"pod", "data", "model"}
    if other:
        raise ValueError(f"FSDP runs on ('data', 'model') meshes (and "
                         f"their pods); this one has {sorted(other)} too")
    shape = mesh.shape
    pods, data = shape.get("pod", 1), shape.get("data", 1)
    grid = [[None] * shape.get("model", 1) for _ in range(pods * data)]
    for e, dev in enumerate(mesh.devices.flat):
        c = entry_coords(mesh, e)
        grid[c.get("pod", 0) * data + c.get("data", 0)][
            c.get("model", 0)] = (e, dev)
    return grid
