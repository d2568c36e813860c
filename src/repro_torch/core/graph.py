"""Fixed-capacity dynamic graph as a directed-doubled edge list (torch).

Port of ``repro.core.graph``.  Each undirected edge occupies two
directed slots; BFS runs level-synchronously as one relaxation of the
whole edge list per level (see ``repro_torch.core.bfs``).

Conventions (identical to the reference, so state dicts are
byte-identical):

* vertex id 0 is the *highest* ranked vertex (rank == id);
* per-vertex arrays have ``n + 1`` rows; row ``n`` is the dump row;
* edge slots beyond the high-water mark ``m2`` and tombstoned slots
  store ``(n, n)``.

``m2`` is a host integer here (the reference keeps it on the device):
every caller knows it on the host, and keeping it there lets the BFS
relax only the ``m2`` live-or-tombstoned slots without a device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

INF = 1 << 28  # safe: INF + INF < int32 max


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``"cuda"`` needs a card.

    There is no silent CPU path: asking for CUDA on a host without it
    raises instead of running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available on "
            f"this host; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph as a capacity-padded directed edge list."""

    src: torch.Tensor  # int32[cap_e], tombstone/pad = n
    dst: torch.Tensor  # int32[cap_e]
    m2: int            # high-water mark of used directed slots (host)
    n: int

    @property
    def cap_e(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_active_directed(self) -> int:
        return int((self.src != self.n).sum())


def _next_pow2(x: int) -> int:
    p = 16
    while p < x:
        p *= 2
    return p


def from_edges(n: int, edges: Sequence[Tuple[int, int]],
               cap_e: int | None = None, *, device="cuda") -> Graph:
    """Build a Graph from an undirected edge list (host-side)."""
    dev = resolve_device(device)
    arr = np.asarray(list(edges), dtype=np.int64).reshape(-1, 2)
    if arr.size and (arr[:, 0] == arr[:, 1]).any():
        raise ValueError("self loops are not allowed")
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    keys = lo * (max(n, 1) + 1) + hi
    _, first, counts = np.unique(keys, return_index=True, return_counts=True)
    if (counts > 1).any():
        dup_at = np.setdiff1d(np.arange(len(keys)), first).min()
        raise ValueError(
            f"duplicate edge {(int(lo[dup_at]), int(hi[dup_at]))}")
    m2 = 2 * arr.shape[0]
    if cap_e is None:
        cap_e = max(16, _next_pow2(m2 + (m2 // 2)))
    if m2 > cap_e:
        raise ValueError(f"cap_e={cap_e} < 2*m={m2}")
    src = np.full(cap_e, n, dtype=np.int32)
    dst = np.full(cap_e, n, dtype=np.int32)
    src[0:m2:2], dst[0:m2:2] = arr[:, 0], arr[:, 1]
    src[1:m2:2], dst[1:m2:2] = arr[:, 1], arr[:, 0]
    return Graph(src=torch.from_numpy(src).to(dev),
                 dst=torch.from_numpy(dst).to(dev), m2=m2, n=n)


def graph_from_numpy(n: int, src, dst, m2, *, device="cuda") -> Graph:
    """A Graph from host arrays (e.g. a reference ``state_dict``)."""
    dev = resolve_device(device)
    # copies: the graph never aliases (possibly read-only) caller arrays
    return Graph(src=torch.tensor(np.asarray(src), dtype=torch.int32,
                                  device=dev),
                 dst=torch.tensor(np.asarray(dst), dtype=torch.int32,
                                  device=dev),
                 m2=int(m2), n=n)


# --------------------------------------------------------------------------
# Dynamic updates (functional: every helper returns a new Graph).
# --------------------------------------------------------------------------
def insert_edge(g: Graph, a: int, b: int) -> Graph:
    """Insert undirected edge (a, b) into two free slots at the high-water
    mark.  Caller must ensure capacity (see :func:`ensure_capacity`)."""
    src = g.src.clone()
    dst = g.dst.clone()
    src[g.m2], src[g.m2 + 1] = a, b
    dst[g.m2], dst[g.m2 + 1] = b, a
    return Graph(src=src, dst=dst, m2=g.m2 + 2, n=g.n)


def delete_edge(g: Graph, a: int, b: int) -> Graph:
    """Tombstone both directed slots of (a, b).

    The slot is the *first* match, as ``jnp.argmax`` picks it in the
    reference (``torch.argmax`` also returns the first maximal index);
    an absent edge tombstones slot 0, as in the reference -- callers
    validate presence first.  Runs without a host sync.
    """
    hit_ab = ((g.src == a) & (g.dst == b)).to(torch.uint8)
    hit_ba = ((g.src == b) & (g.dst == a)).to(torch.uint8)
    at = torch.stack([hit_ab.argmax(), hit_ba.argmax()])
    src = g.src.index_fill(0, at, g.n)
    dst = g.dst.index_fill(0, at, g.n)
    return Graph(src=src, dst=dst, m2=g.m2, n=g.n)


def has_edge(g: Graph, a: int, b: int) -> bool:
    return bool(((g.src == a) & (g.dst == b)).any())


def degrees(g: Graph) -> torch.Tensor:
    """int32[n + 1] out-degree per vertex (row n counts tombstones/pads)."""
    return torch.bincount(g.src.long(), minlength=g.n + 1).to(torch.int32)


def ensure_capacity(g: Graph, extra_directed: int = 2) -> Graph:
    """Host-side: grow the edge arrays if fewer than ``extra_directed``
    slots remain at the high-water mark (compacting first if profitable)."""
    if g.m2 + extra_directed <= g.cap_e:
        return g
    g = compact(g)
    if g.m2 + extra_directed <= g.cap_e:
        return g
    new_cap = _next_pow2(g.m2 + extra_directed)
    src = torch.full((new_cap,), g.n, dtype=torch.int32, device=g.device)
    dst = torch.full((new_cap,), g.n, dtype=torch.int32, device=g.device)
    src[:g.m2] = g.src[:g.m2]
    dst[:g.m2] = g.dst[:g.m2]
    return Graph(src=src, dst=dst, m2=g.m2, n=g.n)


def compact(g: Graph) -> Graph:
    """Host-side: squeeze out tombstones."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    live = src != g.n
    m2 = int(live.sum())
    new_src = np.full(g.cap_e, g.n, dtype=np.int32)
    new_dst = np.full(g.cap_e, g.n, dtype=np.int32)
    new_src[:m2] = src[live]
    new_dst[:m2] = dst[live]
    return Graph(src=torch.from_numpy(new_src).to(g.device),
                 dst=torch.from_numpy(new_dst).to(g.device), m2=m2, n=g.n)


def add_vertices(g: Graph, count: int) -> Graph:
    """Append ``count`` isolated vertices (relabels the dump row)."""
    new_n = g.n + count
    src = torch.where(g.src == g.n, new_n, g.src)
    dst = torch.where(g.dst == g.n, new_n, g.dst)
    return Graph(src=src, dst=dst, m2=g.m2, n=new_n)


def edge_set(g: Graph) -> set:
    """The live undirected edges as ``{(lo, hi)}`` (host-side)."""
    src = g.src[:g.m2].cpu().numpy()
    dst = g.dst[:g.m2].cpu().numpy()
    live = (src != g.n) & (src < dst)
    return set(zip(src[live].tolist(), dst[live].tolist()))
