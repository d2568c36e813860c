"""Distributed DSPC: one controller over a device mesh.

Port of ``repro.core.distributed``.  The reference runs its hot paths
under ``shard_map``; here one process drives every device of a
``repro_torch.launch.mesh.Mesh``, so the service's updater thread, its
readers and its pullers stay in one process with the reference's
contracts (no SPMD ranks issuing collectives in lockstep from several
threads).

* **Edge-sharded relaxation.**  The edge list is split over the mesh's
  ``edge_axis``.  Each shard sits on its device once per graph version
  (:class:`ShardedRelax` keeps the placement of the version it last
  relaxed); one BFS level sends the compressed operand
  (``compress_frontier``) to each distinct device, each shard
  ``index_add_``s its edges into that device's int64 ``[n + 1]`` (or
  ``[B, n + 1]``) partial sums, and one reduction combines the devices'
  partials -- the counterpart of the reference's ``psum``.  Shards on
  one device accumulate into one tensor; distinct cards reduce with
  ``torch.cuda.comm.reduce_add``.  Integer sums make the result exact in
  any order, and the reduction reads nothing back to the host.
* **Query batches split over the batch axes.**  The index is replicated
  once per distinct device of the serving mesh (:func:`replicate_index`)
  and each query shard runs the row-level merge core
  (``gather_rows`` + ``merge_rows``) on its device's copy.
* **Labels stay on the controller's device.**  Bulk label passes run
  once, where the driver keeps the index.

Every algorithm layer (construction, IncSPC, DecSPC, HybSPC) takes a
pluggable ``relax_fn`` / ``multi_relax_fn``, so this module holds no BFS
loop of its own: :func:`make_distributed_updater` binds the sharded
relaxations into the shared algorithm bodies.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.cuda.comm  # a submodule that ``import torch`` leaves unloaded

from repro_torch.core import decremental as D
from repro_torch.core import hybrid as H
from repro_torch.core import incremental as I
from repro_torch.core.bfs import compress_frontier
from repro_torch.core.construct import build_index, build_index_batched
from repro_torch.core.graph import Graph
from repro_torch.core.labels import SPCIndex
from repro_torch.core.query import gather_rows, merge_rows
from repro_torch.launch.mesh import Mesh, alike, collect, working


def pad_graph_for(g: Graph, num_shards: int) -> Graph:
    """Pad the edge arrays so ``cap_e`` divides evenly over the shard
    axis (the pad slots hold ``n``, as the reference's do)."""
    rem = (-g.cap_e) % num_shards
    if rem == 0:
        return g
    pad = torch.full((rem,), g.n, dtype=g.src.dtype, device=g.device)
    return Graph(src=torch.cat([g.src, pad]), dst=torch.cat([g.dst, pad]),
                 m2=g.m2, n=g.n)


def _version_key(x: torch.Tensor) -> tuple:
    return (x.device, x.untyped_storage().data_ptr(), x.storage_offset(),
            tuple(x.shape), x._version)


def _broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> dict:
    """``x`` on each of ``devices`` (distinct): NCCL broadcast across
    cards, the tensor itself where it already lies."""
    if len(devices) > 1 and all(d.type == "cuda" for d in devices) \
            and x.device in devices:
        order = [x.device] + [d for d in devices if d != x.device]
        copies = torch.cuda.comm.broadcast(x, [d.index for d in order])
        return {d: (x if d == x.device else c)
                for d, c in zip(order, copies)}
    return {d: x.to(d) for d in devices}


def _reduce(parts: Dict[torch.device, torch.Tensor],
            dest: torch.device) -> torch.Tensor:
    """Sum one partial per device onto ``dest``: NCCL across cards, a
    plain add otherwise."""
    tensors = list(parts.values())
    if len(tensors) == 1:
        return tensors[0].to(dest)
    if dest.type == "cuda" and all(t.device.type == "cuda"
                                   for t in tensors):
        return torch.cuda.comm.reduce_add(tensors, destination=dest.index)
    out = tensors[0].to(dest)
    for t in tensors[1:]:
        out = out + t.to(dest)
    return out


class ShardedRelax:
    """Edge-sharded relaxation with the ``bfs.RelaxFn`` signature (or
    ``bfs.MultiRelaxFn`` with ``multi=True``).

    ``devices`` holds one entry per edge shard; entries may repeat.  The
    shards of the ``(src, dst)`` version last relaxed stay placed (a
    graph is never written in place, so a version is its storage,
    offset, shape and version counter; the placement holds the arrays,
    so their storage cannot be reused while it is kept).  ``placements``
    counts the versions placed, ``reductions`` the levels reduced (one
    each).
    """

    def __init__(self, devices: Sequence[torch.device],
                 multi: bool = False) -> None:
        self.devices = tuple(devices)
        self.distinct = tuple(dict.fromkeys(self.devices))
        self.num_shards = len(self.devices)
        self.multi = multi
        self.placements = 0
        self.reductions = 0
        self._placed = None  # (key, src, dst, shards): one tuple, swapped

    def shards(self, src: torch.Tensor, dst: torch.Tensor) -> tuple:
        """The ``(device, src_k, dst_k)`` shards of this edge list,
        split as evenly as ``torch.tensor_split`` splits (the live
        prefix need not divide by the shard count)."""
        key = (_version_key(src), _version_key(dst))
        placed = self._placed
        if placed is not None and placed[0] == key:
            return placed[3]
        shards = tuple(
            (d, s.to(d), t.to(d)) for d, s, t in zip(
                self.devices, torch.tensor_split(src, self.num_shards),
                torch.tensor_split(dst, self.num_shards)))
        self._placed = (key, src, dst, shards)
        self.placements += 1
        return shards

    def __call__(self, src, dst, cnt, frontier) -> torch.Tensor:
        shards = self.shards(src, dst)
        operand = _broadcast(compress_frontier(cnt, frontier),
                             self.distinct)
        axis = 1 if self.multi else 0
        parts = {}
        for d, s_k, t_k in shards:
            x = operand[d]
            if d not in parts:
                parts[d] = torch.zeros_like(x)
            parts[d].index_add_(axis, t_k, x.index_select(axis, s_k))
        self.reductions += 1
        return _reduce(parts, cnt.device)


def make_sharded_relax(mesh: Mesh, edge_axis: str) -> ShardedRelax:
    """Edge-sharded single-source relaxation over ``edge_axis`` (one
    reduction per BFS level)."""
    return ShardedRelax(mesh.axis_devices((edge_axis,)))


def make_sharded_multi_relax(mesh: Mesh, edge_axis: str) -> ShardedRelax:
    """Edge-sharded *multi-source* relaxation: ``cnt`` / ``frontier``
    carry a leading hub-batch axis, and one level of a whole hub batch
    still costs one reduction of the ``[B, n + 1]`` partial sums."""
    return ShardedRelax(mesh.axis_devices((edge_axis,)), multi=True)


def make_distributed_builder(mesh: Mesh, edge_axis: str = "model"):
    """HP-SPC construction with edge-sharded BFS levels: ``build(g,
    l_cap) -> SPCIndex`` (the memoised updater's member)."""
    return make_distributed_updater(mesh, edge_axis).build_index


@dataclasses.dataclass(frozen=True)
class DistributedUpdater:
    """Edge-sharded update engine over one mesh axis.

    Each member is the single-device engine with the mesh's sharded
    relaxation bound in, so the update algorithms are the shared bodies
    and their results are the single-device engine's bit for bit.
    Graphs handed to a member keep ``cap_e % num_shards == 0`` when the
    caller pads them with :meth:`pad` after every capacity change (as
    ``DynamicSPC`` does), which keeps ``state_dict()`` equal to the
    reference's mesh mode.
    """

    mesh: Mesh
    edge_axis: str
    num_shards: int
    relax_fn: ShardedRelax
    multi_relax_fn: ShardedRelax
    build_index: Callable           # (g, l_cap) -> SPCIndex
    build_index_batched: Callable   # (g, l_cap=None, hub_batch=, ...)
    inc_spc: Callable               # (g, idx, a, b) -> (g, idx)
    inc_spc_batch: Callable         # (g, idx, edges[B, 2]) -> (g, idx)
    dec_spc: Callable               # (g, idx, a, b) -> (g, idx)
    dec_spc_step: Callable          # dec_spc + isolated-vertex fast path
    dec_spc_batch: Callable         # (g, idx, edges[B, 2]) -> (g, idx)
    hyb_spc_batch: Callable         # (g, idx, events[B, 3]) -> (g, idx)

    def pad(self, g: Graph) -> Graph:
        return pad_graph_for(g, self.num_shards)


@lru_cache(maxsize=None)
def make_distributed_updater(mesh: Mesh,
                             edge_axis: str = "model") -> DistributedUpdater:
    """Edge-sharded IncSPC / DecSPC / HybSPC and construction, memoised
    on ``(mesh, edge_axis)`` so every driver on equal meshes shares one
    relaxation (and its placed edge shards)."""
    if edge_axis not in mesh.shape:
        raise ValueError(f"edge axis {edge_axis!r} not on the mesh "
                         f"(axes: {mesh.axis_names})")
    relax_fn = make_sharded_relax(mesh, edge_axis)
    multi_relax_fn = make_sharded_multi_relax(mesh, edge_axis)
    return DistributedUpdater(
        mesh=mesh,
        edge_axis=edge_axis,
        num_shards=int(mesh.shape[edge_axis]),
        relax_fn=relax_fn,
        multi_relax_fn=multi_relax_fn,
        build_index=partial(build_index, relax_fn=relax_fn),
        build_index_batched=partial(build_index_batched,
                                    multi_relax_fn=multi_relax_fn),
        inc_spc=partial(I.inc_spc, relax_fn=relax_fn),
        inc_spc_batch=partial(I.inc_spc_batch, relax_fn=relax_fn),
        dec_spc=partial(D.dec_spc, relax_fn=relax_fn),
        dec_spc_step=partial(D.dec_spc_step, relax_fn=relax_fn),
        dec_spc_batch=partial(D.dec_spc_batch, relax_fn=relax_fn),
        hyb_spc_batch=partial(H.hyb_spc_batch, relax_fn=relax_fn),
    )


def replicas_of(idx: SPCIndex) -> Dict[torch.device, SPCIndex]:
    """The copies of a (possibly replicated) index, by device."""
    return getattr(idx, "_replicas", None) or {idx.device: idx}


def _copy_to(idx: SPCIndex, device: torch.device) -> SPCIndex:
    if idx.device == device:
        return idx
    return dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).to(device)
        for f in dataclasses.fields(idx) if f.name != "n"})


def replicate_index(mesh: Mesh, idx: SPCIndex) -> SPCIndex:
    """Lay ``idx`` out over every distinct device of ``mesh``.

    The staging half of the snapshot publish protocol
    (``repro_torch.serve.publish.SnapshotStore``): the copies are made
    on each device's current stream before the store's swap, so readers
    that pin the new version never pay a transfer mid-batch.  The result
    is the copy on the mesh's first device, carrying the others
    (:func:`replicas_of`); a device already holding ``idx`` reuses it,
    and no device gets two copies.  The copies live as long as the
    returned index does, so a pinned snapshot keeps them until its last
    reader lets go.
    """
    have = replicas_of(idx)
    copies = {d: have.get(d) or _copy_to(idx, d)
              for d in mesh.distinct_devices}
    first = copies[mesh.distinct_devices[0]]
    if len(copies) == 1:
        return first
    primary = dataclasses.replace(first)  # the first copy's own arrays
    copies[primary.device] = primary
    object.__setattr__(primary, "_replicas", copies)
    return primary


def make_sharded_query(mesh: Mesh, batch_axes: Tuple[str, ...] = ("data",)):
    """Batched SPC queries split over ``batch_axes`` of ``mesh``.

    Returns ``query(idx, s, t) -> (dist int32[B], cnt int64[B])``: B must
    divide by the product of the batch axes' sizes; shard k answers its
    contiguous slice on its device's copy of the index through the
    row-level merge core, and the answers are concatenated in order on
    the first shard's device.  ``repro_torch.serve.QueryEngine.sharded``
    wraps this with bucket padding so callers keep any batch size.
    """
    devices = mesh.axis_devices(batch_axes)
    entries = mesh.axis_entries(batch_axes)

    def query(idx: SPCIndex, s, t):
        s, t = torch.as_tensor(s), torch.as_tensor(t)
        if s.shape[0] % len(devices):
            raise ValueError(
                f"a batch of {s.shape[0]} pairs does not divide over "
                f"{len(devices)} query shards")
        copies = replicas_of(idx)
        if not all(d in copies for d in devices):
            copies = replicas_of(replicate_index(mesh, idx))
        s_k, t_k = (torch.tensor_split(x, len(devices)) for x in (s, t))
        outs = [None] * len(devices)
        # shards of equal size are alike: a dry run answers one for all
        for k, same in alike([x.shape[0] for x in s_k]):
            d, rows = devices[k], copies[devices[k]]
            with working([entries[j] for j in same]):
                out = merge_rows(*gather_rows(rows, s_k[k].to(d).long()),
                                 *gather_rows(rows, t_k[k].to(d).long()))
            for j in same:
                outs[j] = out
        collect("gather", "all-gather", [x for o in outs for x in o])
        home = devices[0]
        return (torch.cat([o[0].to(home) for o in outs]),
                torch.cat([o[1].to(home) for o in outs]))

    return query
