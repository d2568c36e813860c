"""Routing policies: the serving route as a validated value object.

Port of ``repro.serve.routing``:

========  ==============================================================
kind      meaning
========  ==============================================================
auto      ``kernel`` when the index lies on a CUDA device, else ``merge``
merge     plain-torch int64 sorted merge -- exact everywhere
table     plain-torch L x L comparison table (parity debugging)
kernel    the hand-written CUDA ``spc_query`` kernel (int64, exact for
          every row); on a CPU index its plain version
sharded   the index replicated over a serving mesh, the batch split over
          its ``batch_axes`` (the merge core only, as the reference)
========  ==============================================================

An unknown kind, or a ``sharded`` policy without batch axes, raises
``ValueError`` when the policy is built, not when the first batch
arrives.  Policies are frozen (hashable, comparable) so configs can
carry them as plain values; :meth:`RoutePolicy.coerce` upgrades route
strings and ``{"kind": ..., "batch_axes": ...}`` mappings.  The
reference's ``"pallas"`` names the TPU kernel route and coerces to
``kernel``; its Pallas knobs (``block_b``, ``interpret``) have no
counterpart, since the CUDA kernel takes none.

The reference also reads a per-row 2^24 count bound
(``core/query.py::cached_count_bound``) to keep its f32 kernel exact;
K1 counts in int64, so no route of the port partitions a batch and the
port's copies of those helpers have no caller here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

#: Kinds a policy may name.  The first four are single-device engine
#: routes; ``sharded`` selects the multi-device replica path
#: (``QueryEngine.sharded``) and needs a serving mesh at bind time.
KINDS = ("auto", "merge", "table", "kernel", "sharded")

#: The reference's kind names that have another name here.
_ALIASES = {"pallas": "kernel"}


@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """One validated serving-route decision (see module doc)."""

    kind: str
    #: Mesh axes the batch is split over (``sharded`` only).
    batch_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind in _ALIASES:
            object.__setattr__(self, "kind", _ALIASES[self.kind])
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown route kind {self.kind!r}; want one of {KINDS}")
        if self.kind == "sharded":
            axes = tuple(self.batch_axes)
            if not axes or not all(isinstance(a, str) and a for a in axes):
                raise ValueError(
                    f"sharded route needs non-empty mesh axis names, got "
                    f"batch_axes={self.batch_axes!r}")
            object.__setattr__(self, "batch_axes", axes)
        elif self.batch_axes:
            raise ValueError(
                f"batch_axes only apply to the 'sharded' route, not "
                f"{self.kind!r}")

    @classmethod
    def sharded(cls, batch_axes: Tuple[str, ...] = ("data",)
                ) -> "RoutePolicy":
        return cls("sharded", batch_axes=tuple(batch_axes))

    @classmethod
    def coerce(cls, route) -> "RoutePolicy":
        """Upgrade a route name, a ``{"kind": ...}`` mapping or None
        (``auto``) to a policy; policies pass through."""
        if route is None:
            return cls("auto")
        if isinstance(route, RoutePolicy):
            return route
        if isinstance(route, str):
            if route == "sharded":
                return cls.sharded()   # default batch axes
            return cls(route)
        if isinstance(route, Mapping):
            kw = dict(route)
            kind = kw.pop("kind", "auto")
            axes = tuple(kw.pop("batch_axes", ()))
            if kw:
                raise ValueError(
                    f"route mapping has unknown keys {sorted(kw)}; the "
                    f"port's policies carry only 'kind' and 'batch_axes' "
                    f"(the CUDA kernel takes no knobs)")
            return cls(kind, batch_axes=axes)
        raise ValueError(
            f"route must be a RoutePolicy or one of {KINDS}, got "
            f"{type(route).__name__} {route!r}")

    @property
    def needs_mesh(self) -> bool:
        """True when binding this policy requires a serving mesh."""
        return self.kind == "sharded"

    @property
    def engine_route(self) -> str:
        """The single-device engine route evaluating this policy's
        batches (the sharded replica path shards the merge core only)."""
        return "merge" if self.kind == "sharded" else self.kind
