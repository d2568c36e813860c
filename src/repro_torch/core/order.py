"""Vertex-ordering strategies for index construction (the PSPC knob).

Port of ``repro.core.order``: the numpy ``Ordering`` machinery is a
copy of the reference's, ``relabel_graph`` is rewritten in torch.

Every engine keeps the *rank == vertex id* invariant; an
:class:`Ordering` is applied once, at the id boundary of the driver
(``repro_torch.core.dynamic.DynamicSPC``).  Orderings are pure
functions of the (n, edges) multiset -- degree ties break by ascending
external id via a stable sort -- so two builds of the same graph
produce byte-identical state dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

#: Supported ordering strategy names.
ORDERS = ("id", "degree")


@dataclasses.dataclass(frozen=True)
class Ordering:
    """A vertex permutation between external ids and rank space.

    ``rank_of[ext] == internal`` and ``vertex_of[internal] == ext``;
    both are host numpy int32 arrays of length n.
    """

    rank_of: np.ndarray
    vertex_of: np.ndarray
    order: str

    @property
    def n(self) -> int:
        return int(self.rank_of.shape[0])

    @property
    def identity(self) -> bool:
        return self.order == "id"

    def to_internal(self, v):
        """External id(s) -> rank-space id(s), bounds-checked first."""
        if self.identity:
            return v
        arr = np.asarray(v)
        if arr.size and (arr.min() < 0 or arr.max() >= self.n):
            bad = arr[(arr < 0) | (arr >= self.n)].flat[0]
            raise ValueError(
                f"vertex id {int(bad)} out of range [0, {self.n})")
        out = self.rank_of[arr]
        return int(out) if np.isscalar(v) or np.ndim(v) == 0 else out

    def to_external(self, v):
        """Rank-space id(s) -> external id(s)."""
        if self.identity:
            return v
        out = self.vertex_of[np.asarray(v)]
        return int(out) if np.isscalar(v) or np.ndim(v) == 0 else out

    def edges_to_internal(self, edges) -> list:
        if self.identity:
            return list(edges)
        return [(int(self.rank_of[a]), int(self.rank_of[b]))
                for a, b in edges]

    def grow(self, count: int) -> "Ordering":
        """Append ``count`` fresh vertices at the lowest ranks."""
        fresh = np.arange(self.n, self.n + count, dtype=np.int32)
        return Ordering(rank_of=np.concatenate([self.rank_of, fresh]),
                        vertex_of=np.concatenate([self.vertex_of, fresh]),
                        order=self.order)


def identity_ordering(n: int) -> Ordering:
    ids = np.arange(n, dtype=np.int32)
    return Ordering(rank_of=ids, vertex_of=ids, order="id")


def _from_degrees(deg: np.ndarray, order: str) -> Ordering:
    # stable sort on -degree: equal degrees keep ascending-id order
    vertex_of = np.argsort(-deg, kind="stable").astype(np.int32)
    rank_of = np.empty(deg.shape[0], dtype=np.int32)
    rank_of[vertex_of] = np.arange(deg.shape[0], dtype=np.int32)
    return Ordering(rank_of=rank_of, vertex_of=vertex_of, order=order)


def _check_order(order: str) -> None:
    if order not in ORDERS:
        raise ValueError(f"unknown vertex order {order!r}; want one of "
                         f"{ORDERS}")


def vertex_ordering(n: int, edges: Sequence[Tuple[int, int]],
                    order: str = "id") -> Ordering:
    """The deterministic :class:`Ordering` for an edge list: ``"id"``
    (identity) or ``"degree"`` (descending degree, ties by id)."""
    _check_order(order)
    if order == "id":
        return identity_ordering(n)
    arr = np.asarray(list(edges), dtype=np.int64).reshape(-1, 2)
    deg = np.bincount(arr.reshape(-1), minlength=n).astype(np.int64)
    return _from_degrees(deg, order)


def graph_ordering(g, order: str = "id") -> Ordering:
    """The deterministic :class:`Ordering` of an already-built Graph
    (degrees read off the doubled edge list)."""
    _check_order(order)
    if order == "id":
        return identity_ordering(g.n)
    from repro_torch.core.graph import degrees

    deg = degrees(g).cpu().numpy()[: g.n].astype(np.int64)
    return _from_degrees(deg, order)


def relabel_graph(g, ordering: Ordering):
    """Permute a Graph's vertex ids into rank space.

    Edge slots keep their positions; only the ids stored in them are
    mapped.  The dump row ``n`` maps to itself.
    """
    if ordering.identity:
        return g
    rank_ext = torch.cat([
        torch.as_tensor(ordering.rank_of, dtype=torch.int32),
        torch.tensor([g.n], dtype=torch.int32),   # dump row -> dump row
    ]).to(g.device)
    return dataclasses.replace(g, src=rank_ext[g.src.long()],
                               dst=rank_ext[g.dst.long()])


def ordering_from_state(vertex_of: np.ndarray, order: str = "degree"
                        ) -> Ordering:
    """Rebuild an :class:`Ordering` from its state-dict leaf, validating
    that ``vertex_of`` is a permutation of [0, n)."""
    vertex_of = np.asarray(vertex_of, dtype=np.int32)
    n = vertex_of.shape[0]
    if not np.array_equal(np.sort(vertex_of), np.arange(n, dtype=np.int32)):
        raise ValueError(
            "state['order.vertex_of'] is not a permutation of "
            f"[0, {n})")
    if np.array_equal(vertex_of, np.arange(n, dtype=np.int32)):
        return identity_ordering(n)
    rank_of = np.empty(n, dtype=np.int32)
    rank_of[vertex_of] = np.arange(n, dtype=np.int32)
    return Ordering(rank_of=rank_of, vertex_of=vertex_of, order=order)
