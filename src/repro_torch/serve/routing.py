"""Routing policies: the serving route as a validated value object.

Port of ``repro.serve.routing`` for the single-device routes:

========  ==============================================================
kind      meaning
========  ==============================================================
auto      ``kernel`` when the index lies on a CUDA device, else ``merge``
merge     plain-torch int64 sorted merge -- exact everywhere
table     plain-torch L x L comparison table (parity debugging)
kernel    the hand-written CUDA ``spc_query`` kernel (int64, exact for
          every row); on a CPU index its plain version
========  ==============================================================

An unknown kind raises ``ValueError`` when the policy is built, not
when the first batch arrives.  Policies are frozen (hashable,
comparable) so configs can carry them as plain values;
:meth:`RoutePolicy.coerce` upgrades route strings and ``{"kind": ...}``
mappings.  The reference's ``"pallas"`` names the TPU kernel route and
coerces to ``kernel``; its Pallas knobs (``block_b``, ``interpret``)
have no counterpart, since the CUDA kernel takes none.  Its
``"sharded"`` route belongs to the distributed slice of the port
(ROADMAP queue 1, item 5) and raises ``NotImplementedError``.

The reference also reads a per-row 2^24 count bound
(``core/query.py::cached_count_bound``) to keep its f32 kernel exact;
K1 counts in int64, so no route of the port partitions a batch and the
port's copies of those helpers have no caller here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

#: Kinds a policy may name; each is one engine route.
KINDS = ("auto", "merge", "table", "kernel")

#: The reference's kind names that have another name here.
_ALIASES = {"pallas": "kernel"}

_SHARDED = ("the 'sharded' route belongs to the distributed slice of the "
            "port (ROADMAP queue 1, item 5)")


@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """One validated serving-route decision (see module doc)."""

    kind: str

    def __post_init__(self):
        if self.kind == "sharded":
            raise NotImplementedError(_SHARDED)
        if self.kind in _ALIASES:
            object.__setattr__(self, "kind", _ALIASES[self.kind])
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown route kind {self.kind!r}; want one of {KINDS}")

    @classmethod
    def coerce(cls, route) -> "RoutePolicy":
        """Upgrade a route name, a ``{"kind": ...}`` mapping or None
        (``auto``) to a policy; policies pass through."""
        if route is None:
            return cls("auto")
        if isinstance(route, RoutePolicy):
            return route
        if isinstance(route, str):
            return cls(route)
        if isinstance(route, Mapping):
            kw = dict(route)
            kind = kw.pop("kind", "auto")
            if kw:
                raise ValueError(
                    f"route mapping has unknown keys {sorted(kw)}; the "
                    f"port's policies carry only 'kind' (the CUDA kernel "
                    f"takes no knobs)")
            return cls(kind)
        raise ValueError(
            f"route must be a RoutePolicy or one of {KINDS}, got "
            f"{type(route).__name__} {route!r}")

    @property
    def needs_mesh(self) -> bool:
        """True when binding this policy requires a serving mesh: never
        for the port's kinds (``sharded`` raises when built)."""
        return False

    @property
    def engine_route(self) -> str:
        """The engine route evaluating this policy's batches."""
        return self.kind
