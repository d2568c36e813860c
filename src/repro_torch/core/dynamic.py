"""DynamicSPC: the host-side driver of the DSPC index lifecycle.

Port of ``repro.core.dynamic``.  Beyond the algorithm
steps it owns:

* capacity management -- grows the edge arrays and the label matrices
  (overflow retry: an update that loses label writes is replayed from
  the pre-op / pre-chunk snapshot at doubled capacity);
* the isolated-vertex fast path of Section 3.2.3;
* vertex insertion / deletion (reduction to edge events);
* chunked event replay through ``repro_torch.core.hybrid`` with
  host-side stream validation;
* state dicts with the reference's keys, dtypes and bytes, in both
  directions, plus a monotone update version;
* snapshot publishing: ``attach_store()`` wires a
  ``repro_torch.serve.SnapshotStore`` that receives every committed
  index at its version;
* restore from a checkpoint directory (:meth:`DynamicSPC.from_checkpoint`)
  written by either package.

Every entry point runs on ``device`` (default ``"cuda"``); the CPU is
used only when asked for.  ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``)
runs the build and every update through the edge-sharded engines of
``repro_torch.core.distributed.make_distributed_updater``: the same
algorithms with the relaxation split over the mesh's ``edge_axis``,
driven from this process, while the graph and the labels stay on
``device`` and the capacity and overflow-retry machinery runs
unchanged; the edge arrays are re-padded to the shard count after every
capacity change, so ``state_dict()`` equals the reference's mesh mode.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

from repro_torch.analysis.shadow import make_lock
from repro_torch.core import graph as G
from repro_torch.core import labels as L
from repro_torch.core.construct import (build_index, build_index_batched,
                                        provision_l_cap)
from repro_torch.core.decremental import dec_spc
from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.hybrid import OP_DELETE, OP_INSERT, hyb_spc_batch
from repro_torch.core.incremental import inc_spc, inc_spc_batch
from repro_torch.core.labels import SPCIndex
from repro_torch.core.order import (identity_ordering, ordering_from_state,
                                    vertex_ordering)

#: Default chunk size for batched event replay.
DEFAULT_BATCH = 64

#: The single-device build and update engines, by the name of the
#: ``DistributedUpdater`` member that replaces each on a mesh.
_ENGINES = {"build_index": build_index,
            "build_index_batched": build_index_batched,
            "inc_spc": inc_spc, "inc_spc_batch": inc_spc_batch,
            "dec_spc": dec_spc, "hyb_spc_batch": hyb_spc_batch}


@dataclasses.dataclass(frozen=True)
class UpdateStatsView:
    """Point-in-time frozen copy of an ``UpdateStats`` (``snapshot``)."""

    inserts: int
    deletions: int
    isolated_fast_path: int
    label_regrows: int
    edge_regrows: int
    batches: int
    batched_events: int

    @property
    def events_per_batch(self) -> float:
        return self.batched_events / self.batches if self.batches else 0.0


@dataclasses.dataclass
class UpdateStats:
    inserts: int = 0
    deletions: int = 0
    isolated_fast_path: int = 0  # host-side fast path only; the batched
    # engine takes the same shortcut without counting.
    label_regrows: int = 0
    edge_regrows: int = 0
    batches: int = 0          # hybrid-engine chunks
    batched_events: int = 0   # events carried by those chunks

    def __post_init__(self):
        self._lock = make_lock("update_stats.lock")

    def bump(self, **deltas: int) -> None:
        """Lock-guarded counter increments (the only write path)."""
        with self._lock:
            for key, d in deltas.items():
                setattr(self, key, getattr(self, key) + d)

    def snapshot(self) -> UpdateStatsView:
        """Lock-guarded frozen copy for cross-thread readers."""
        with self._lock:
            return UpdateStatsView(**{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)})

    @property
    def events_per_batch(self) -> float:
        return self.batched_events / self.batches if self.batches else 0.0


def _updater_for(mesh, edge_axis: str):
    if mesh is None:
        return None
    from repro_torch.core.distributed import make_distributed_updater
    return make_distributed_updater(mesh, edge_axis)


class DynamicSPC:
    """Maintains (graph, SPC-Index) under a stream of topology events.

    With ``mesh=`` the build and every update run through the
    edge-sharded engines (``repro_torch.core.distributed``); queries,
    events, overflow retry and state dicts are unchanged, and the two
    modes stay bit-identical.
    """

    def __init__(self, n: int, edges: Sequence[Tuple[int, int]] = (),
                 l_cap: int | None = 32, cap_e: int | None = None, *,
                 mesh=None, edge_axis: str = "model", device="cuda",
                 construct_batch: int | None = None,
                 vertex_order: str = "id") -> None:
        """``construct_batch`` >= 2 builds through the batched PSPC-style
        constructor (same index); ``vertex_order="degree"`` relabels ids
        into degree-rank space at this driver's id boundary;
        ``l_cap=None`` pre-provisions the label capacity from the
        graph's degree statistics."""
        self.device = resolve_device(device)
        self.stats = UpdateStats()
        self._engine = None
        self._store = None
        self._updater = _updater_for(mesh, edge_axis)
        self.version = 0  # bumped per committed update
        self._construct_batch = construct_batch
        self.order = vertex_ordering(n, edges, vertex_order)
        self.graph = self._pad_for_mesh(G.from_edges(
            n, self.order.edges_to_internal(edges), cap_e,
            device=self.device))
        self.index = self._build(l_cap)

    def _pad_for_mesh(self, g: Graph) -> Graph:
        """Keep cap_e divisible over the edge axis (no-op off-mesh)."""
        return self._updater.pad(g) if self._updater is not None else g

    def _op(self, name: str):
        """The build / update engine ``name``: the updater's edge-sharded
        member on a mesh, the single-device function otherwise."""
        if self._updater is not None:
            return getattr(self._updater, name)
        return _ENGINES[name]

    # -- construction with overflow-retry ---------------------------------
    def _build(self, l_cap: int | None) -> SPCIndex:
        if self._construct_batch is not None and self._construct_batch >= 2:
            return self._op("build_index_batched")(
                self.graph, l_cap, hub_batch=self._construct_batch,
                on_regrow=lambda _cap: self.stats.bump(label_regrows=1))
        if l_cap is None:
            l_cap = provision_l_cap(self.graph)
        build = self._op("build_index")
        while True:
            idx = build(self.graph, l_cap)
            if int(idx.overflow) == 0:
                return idx
            l_cap *= 2
            self.stats.bump(label_regrows=1)

    def rebuild(self) -> None:
        """Reconstruction baseline (what the paper's HP-SPC rerun does)."""
        self.index = self._build(self.index.l_cap)
        self._commit()

    @property
    def n(self) -> int:
        return self.graph.n

    # -- queries -----------------------------------------------------------
    @property
    def engine(self):
        """The serving engine every query entry point routes through."""
        if self._engine is None:
            from repro_torch.serve.engine import QueryEngine
            self._engine = QueryEngine()
        return self._engine

    # -- snapshot publishing -------------------------------------------------
    def attach_store(self, store=None, **store_kwargs):
        """Attach (or create, with ``store_kwargs`` such as
        ``transport=`` or ``checkpoint_dir=``) a
        ``repro_torch.serve.SnapshotStore``: every committed update from
        here on publishes the new index at its bumped version
        (``src/repro/core/dynamic.py:201``).  Only committed states
        publish -- a chunk that overflows and replays never exposes its
        intermediate index.  A store ahead of this index's version
        raises ``ValueError``."""
        if store is None:
            from repro_torch.serve.publish import SnapshotStore
            store = SnapshotStore(self.index, version=self.version,
                                  **store_kwargs)
        elif store.version is not None and store.version > self.version:
            raise ValueError(
                f"store is at version {store.version}, ahead of this "
                f"service (version {self.version}); restore a newer "
                f"state or attach a fresh store")
        elif store.version is None or store.version < self.version:
            store.publish(self.index, version=self.version)
        self._store = store
        return store

    def _commit(self) -> None:
        """Bump the version and publish the committed snapshot (if a
        store is attached).  Called exactly once per successful public
        mutation / event chunk, after overflow retry has settled."""
        self.version += 1
        if self._store is not None:
            self._store.publish(self.index, version=self.version)

    def query(self, s: int, t: int) -> Tuple[int, int]:
        return self.engine.query_pair(
            self.index, self.order.to_internal(s), self.order.to_internal(t))

    def query_batch(self, s, t, route: str | None = None):
        return self.engine.query_batch(
            self.index, self.order.to_internal(s), self.order.to_internal(t),
            route=route)

    # -- updates -----------------------------------------------------------
    def _check_vertex(self, v: int, *, what: str = "vertex") -> None:
        v = int(v)
        if not 0 <= v < self.n:
            raise ValueError(f"{what} id {v} out of range [0, {self.n})")

    def _check_edge_ids(self, a: int, b: int) -> None:
        self._check_vertex(a, what="endpoint")
        self._check_vertex(b, what="endpoint")
        if int(a) == int(b):
            raise ValueError(f"self loop ({a},{b}) not allowed")

    def _retry(self, step):
        """Run ``step(graph, index)`` until no label write is lost,
        regrowing the pre-op index; commit the result."""
        while True:
            g2, idx2 = step(self.graph, self.index)
            if int(idx2.overflow) == 0:
                self.graph, self.index = g2, idx2
                return
            self.index = L.repad(self.index, self.index.l_cap * 2)
            self.stats.bump(label_regrows=1)

    def insert_edge(self, a: int, b: int) -> None:
        self._check_edge_ids(a, b)
        a, b = self.order.to_internal(a), self.order.to_internal(b)
        if G.has_edge(self.graph, a, b):
            raise ValueError(f"edge ({a},{b}) already present")
        self.graph = self._pad_for_mesh(G.ensure_capacity(self.graph, 2))
        inc = self._op("inc_spc")
        self._retry(lambda g, idx: inc(g, idx, a, b))
        self.stats.bump(inserts=1)
        self._commit()

    def delete_edge(self, a: int, b: int) -> None:
        self._check_edge_ids(a, b)
        a, b = self.order.to_internal(a), self.order.to_internal(b)
        if not G.has_edge(self.graph, a, b):
            raise ValueError(f"edge ({a},{b}) not present")
        hi = max(a, b)
        if int(G.degrees(self.graph)[hi]) == 1:
            # Section 3.2.3: the lower-ranked endpoint becomes isolated and
            # is never a hub elsewhere -- reset its row to the self label.
            self.graph = G.delete_edge(self.graph, a, b)
            self.index = L.reset_isolated_row(self.index, hi)
            self.stats.bump(isolated_fast_path=1)
        else:
            dec = self._op("dec_spc")
            self._retry(lambda g, idx: dec(g, idx, a, b))
        self.stats.bump(deletions=1)
        self._commit()

    def insert_edges(self, edges) -> None:
        """Batched insertion: one engine call for the whole batch."""
        edges = [(a, b) for a, b in edges]
        for a, b in edges:
            self._check_edge_ids(a, b)
        edges = self.order.edges_to_internal(edges)
        for a, b in edges:
            if G.has_edge(self.graph, a, b):
                raise ValueError(f"edge ({a},{b}) already present")
        self.graph = self._pad_for_mesh(
            G.ensure_capacity(self.graph, 2 * len(edges)))
        batch = self._op("inc_spc_batch")
        self._retry(lambda g, idx: batch(g, idx, edges))
        self.stats.bump(inserts=len(edges))
        self._commit()

    def insert_vertex(self) -> int:
        """Append an isolated vertex (lowest rank)."""
        self.graph = G.add_vertices(self.graph, 1)
        self.index = L.add_vertices(self.index, 1)
        self.order = self.order.grow(1)  # fresh id maps to itself
        self._commit()
        return self.n - 1

    def delete_vertex(self, v: int,
                      batch_size: int | None = DEFAULT_BATCH) -> None:
        """Reduce to edge deletions (Section 3) and replay them through
        the batched engine."""
        self._check_vertex(v)
        vi = self.order.to_internal(v)
        src = self.graph.src.cpu().numpy()
        dst = self.graph.dst.cpu().numpy()
        nbrs = np.unique(dst[(src == vi) & (dst != self.n)])
        if not nbrs.size:
            return
        self.apply_events(
            [("-", v, int(self.order.to_external(u))) for u in nbrs],
            batch_size=batch_size)

    # -- batched event replay (the hybrid engine) ---------------------------
    def _normalize_events(self, events) -> list:
        """Host-side op-tag validation: ``'+'``/``'-'`` and the engine
        codes ``OP_INSERT``/``OP_DELETE`` are accepted; anything else
        raises ``ValueError`` naming the first bad row (the engine would
        treat it as padding)."""
        out = []
        for i, ev in enumerate(events):
            try:
                op, a, b = ev
            except (TypeError, ValueError):
                raise ValueError(
                    f"event row {i}: want an (op, a, b) triple, got {ev!r}"
                ) from None
            if isinstance(op, (int, np.integer)) and \
                    not isinstance(op, bool):
                if op == OP_INSERT:
                    op = "+"
                elif op == OP_DELETE:
                    op = "-"
            if op not in ("+", "-"):
                raise ValueError(
                    f"unknown event op {op!r} at row {i}: want '+'/'-' or "
                    f"OP_INSERT/OP_DELETE (the batched engine would "
                    f"silently treat this row as padding)")
            try:
                out.append((op, int(a), int(b)))
            except (TypeError, ValueError):
                raise ValueError(
                    f"event row {i}: non-integer endpoint in "
                    f"({a!r}, {b!r})") from None
        return out

    def _validate_events(self, events) -> None:
        """Host-side simulation of the stream against the current edge
        set, so per-event error semantics hold before any device work."""
        present = G.edge_set(self.graph)
        for i, (op, a, b) in enumerate(events):
            try:
                self._check_edge_ids(a, b)
            except ValueError as e:
                raise ValueError(f"event row {i}: {e}") from None
            key = (a, b) if a < b else (b, a)
            if op == "+":
                if key in present:
                    raise ValueError(
                        f"event row {i}: edge {key} already present")
                present.add(key)
            else:
                if key not in present:
                    raise ValueError(f"event row {i}: edge {key} not present")
                present.discard(key)

    def apply_events(self, events: Iterable[Tuple[str, int, int]],
                     batch_size: int | None = DEFAULT_BATCH) -> None:
        """Apply a stream of ('+'|'-', a, b) events (Section 4.4).

        The stream is chunked; each chunk gets one edge-capacity
        pre-provision and replays through ``hyb_spc_batch``.  On label
        overflow anywhere in the chunk the pre-chunk snapshot is
        re-padded at doubled capacity and the chunk replays.
        ``batch_size=None`` (or <= 1) applies one event at a time.
        """
        events = self._normalize_events(events)
        if batch_size is None or batch_size <= 1:
            for op, a, b in events:
                if op == "+":
                    self.insert_edge(a, b)
                else:
                    self.delete_edge(a, b)
            return
        events = [(op, self.order.to_internal(a), self.order.to_internal(b))
                  for op, a, b in events]
        self._validate_events(events)
        code = {"+": OP_INSERT, "-": OP_DELETE}
        hyb = self._op("hyb_spc_batch")
        for lo in range(0, len(events), batch_size):
            chunk = events[lo:lo + batch_size]
            arr = np.zeros((batch_size, 3), dtype=np.int32)  # (0,0,0) pads
            for i, (op, a, b) in enumerate(chunk):
                arr[i] = (code[op], a, b)
            n_ins = sum(1 for op, _, _ in chunk if op == "+")
            cap_before = self.graph.cap_e
            self.graph = self._pad_for_mesh(
                G.ensure_capacity(self.graph, 2 * n_ins))
            if self.graph.cap_e != cap_before:
                self.stats.bump(edge_regrows=1)
            g0, idx0 = self.graph, self.index  # pre-chunk snapshot
            while True:
                g2, idx2 = hyb(self.graph, self.index, arr)
                if int(idx2.overflow) == 0:
                    self.graph, self.index = g2, idx2
                    break
                self.graph = g0
                self.index = L.repad(idx0, self.index.l_cap * 2)
                self.stats.bump(label_regrows=1)
            self.stats.bump(batches=1, batched_events=len(chunk),
                            inserts=n_ins, deletions=len(chunk) - n_ins)
            self._commit()

    # -- introspection -------------------------------------------------------
    def index_entries(self) -> int:
        return self.index.total_entries()

    def index_bytes(self) -> int:
        """Paper's packed accounting: 8 bytes per label entry."""
        return 8 * self.index_entries()

    def state_dict(self) -> dict:
        """Host numpy state with the reference's keys, dtypes and bytes
        (``repro.core.dynamic.DynamicSPC.from_state_dict`` loads it)."""
        state = {
            "graph.src": self.graph.src.cpu().numpy(),
            "graph.dst": self.graph.dst.cpu().numpy(),
            "graph.m2": np.asarray(self.graph.m2, dtype=np.int32),
            "index.hub": self.index.hub.cpu().numpy(),
            "index.dist": self.index.dist.cpu().numpy(),
            "index.cnt": self.index.cnt.cpu().numpy(),
            "index.size": self.index.size.cpu().numpy(),
            "index.cnt_sum": self.index.cnt_sum.cpu().numpy(),
            "version": np.asarray(self.version, dtype=np.int64),
        }
        if not self.order.identity:
            state["order.vertex_of"] = np.asarray(self.order.vertex_of,
                                                  np.int32)
        return state

    @staticmethod
    def _validate_state(n: int, state: dict) -> dict:
        """Host-side schema check of a state dict; every violation
        raises ``ValueError`` naming the offending key.  Returns the
        leaves as host numpy arrays."""
        required = ("graph.src", "graph.dst", "graph.m2",
                    "index.hub", "index.dist", "index.cnt", "index.size")
        for key in required:
            if key not in state:
                raise ValueError(f"state dict missing key {key!r}")
        host = {}
        for key in state:
            arr = np.asarray(state[key])
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"state[{key!r}] has non-integer dtype {arr.dtype}")
            host[key] = arr

        def want(key, shape):
            if host[key].shape != shape:
                raise ValueError(
                    f"state[{key!r}] has shape {host[key].shape}, "
                    f"want {shape} (n={n})")

        cap_e = host["graph.src"].shape
        if len(cap_e) != 1:
            raise ValueError(
                f"state['graph.src'] must be 1-D, got shape {cap_e}")
        want("graph.dst", cap_e)
        want("graph.m2", ())
        m2 = int(host["graph.m2"])
        if not 0 <= m2 <= cap_e[0]:
            raise ValueError(
                f"state['graph.m2'] = {m2} outside [0, cap_e={cap_e[0]}]")
        hub = host["index.hub"].shape
        if len(hub) != 2 or hub[0] != n + 1:
            raise ValueError(
                f"state['index.hub'] has shape {hub}, want (n + 1 = "
                f"{n + 1}, l_cap)")
        want("index.dist", hub)
        want("index.cnt", hub)
        want("index.size", (n + 1,))
        if "index.cnt_sum" in host:
            want("index.cnt_sum", (n + 1,))
        if "order.vertex_of" in host:
            want("order.vertex_of", (n,))
        if "version" in host:
            want("version", ())
            if int(host["version"]) < 0:
                raise ValueError(
                    f"state['version'] = {int(host['version'])} < 0")
        return host

    @classmethod
    def from_state_dict(cls, n: int, state: dict, *, mesh=None,
                        edge_axis: str = "model", device="cuda",
                        construct_batch: int | None = None) -> "DynamicSPC":
        """Restore from a state dict of host arrays -- this port's or the
        reference's ``state_dict()`` converted with ``np.asarray`` --
        including legacy dicts without ``index.cnt_sum`` / ``version``
        and the optional ``order.vertex_of`` permutation.  ``mesh=``
        restores into the edge-sharded mode (the edge arrays re-padded
        to the shard count)."""
        host = cls._validate_state(n, state)
        obj = cls.__new__(cls)
        obj.device = resolve_device(device)
        obj.stats = UpdateStats()
        obj._engine = None
        obj._store = None
        obj._updater = _updater_for(mesh, edge_axis)
        obj.version = int(host.get("version", 0))
        obj._construct_batch = construct_batch
        obj.order = (ordering_from_state(host["order.vertex_of"])
                     if "order.vertex_of" in host else identity_ordering(n))
        obj.graph = obj._pad_for_mesh(G.graph_from_numpy(
            n, host["graph.src"], host["graph.dst"], host["graph.m2"],
            device=obj.device))
        obj.index = L.index_from_numpy(
            n, host["index.hub"], host["index.dist"], host["index.cnt"],
            host["index.size"], host.get("index.cnt_sum"),
            device=obj.device)
        return obj

    @classmethod
    def from_checkpoint(cls, path: str, n: int, step: int | None = None, *,
                        mesh=None, edge_axis: str = "model", device="cuda",
                        construct_batch: int | None = None) -> "DynamicSPC":
        """Restore from a checkpoint directory of a ``state_dict()``
        written by either package (``src/repro/core/dynamic.py:611``).

        The restore template comes from the committed manifest, so all
        three leaf schemas restore: with ``order.vertex_of`` (10
        leaves), the current one (9) and the legacy one without
        ``index.cnt_sum`` / ``version`` (7).  The leaves are read to the
        host and placed on ``device`` by :meth:`from_state_dict`.
        """
        from repro_torch.train import checkpoint as C
        man = C.manifest(path, step)
        ordered = sorted(("graph.src", "graph.dst", "graph.m2", "index.hub",
                          "index.dist", "index.cnt", "index.size",
                          "index.cnt_sum", "order.vertex_of", "version"))
        new = sorted(k for k in ordered if k != "order.vertex_of")
        legacy = sorted(k for k in new
                        if k not in ("index.cnt_sum", "version"))
        for keys in (ordered, new, legacy):
            if len(keys) == len(man["shapes"]):
                break
        else:
            raise ValueError(
                f"checkpoint at {path} has {len(man['shapes'])} leaves; "
                f"not a DynamicSPC state dict")
        tree_like = {
            k: np.empty(shape, dtype=np.dtype(dt))
            for k, shape, dt in zip(keys, man["shapes"], man["dtypes"])
        }
        state, _, _ = C.restore(path, tree_like, step=man["step"],
                                device="cpu")
        return cls.from_state_dict(n, state, mesh=mesh, edge_axis=edge_axis,
                                   device=device,
                                   construct_batch=construct_batch)
