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
:meth:`RoutePolicy.coerce` upgrades route strings.
"""

from __future__ import annotations

import dataclasses

#: Kinds a policy may name; each is one engine route.
KINDS = ("auto", "merge", "table", "kernel")


@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """One validated serving-route decision (see module doc)."""

    kind: str

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown route kind {self.kind!r}; want one of {KINDS}")

    @classmethod
    def coerce(cls, route) -> "RoutePolicy":
        """Upgrade a route name or None (``auto``) to a policy;
        policies pass through."""
        if route is None:
            return cls("auto")
        if isinstance(route, RoutePolicy):
            return route
        if isinstance(route, str):
            return cls(route)
        raise ValueError(
            f"route must be a RoutePolicy or one of {KINDS}, got "
            f"{type(route).__name__} {route!r}")
