"""Static + runtime lock and trace-safety analysis (the port's own copy).

* ``repro_torch.analysis.shadow`` -- lock factories with the canonical
  names of ``hierarchy.HIERARCHY``; with ``REPRO_SHADOW_LOCKS=1`` they
  hand out instrumented locks that enforce the hierarchy.
* ``repro_torch.analysis.lockorder`` -- the AST lock-order analyzer.
* ``repro_torch.analysis.rules`` -- the trace-safety / serve-hygiene
  lint rules.
* ``python -m repro_torch.analysis [--baseline ...] [paths ...]`` -- the
  gate: findings as ``file:line rule-id message``, non-zero exit on any
  unbaselined finding; ``--self-test`` runs the per-rule fixtures.
"""

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.hierarchy import HIERARCHY, RANKS, REENTRANT
from repro_torch.analysis.shadow import (LockHierarchyViolation,
                                         assert_no_locks_held, held_locks,
                                         make_condition, make_lock,
                                         shadow_enabled)

__all__ = ["Finding", "HIERARCHY", "LockHierarchyViolation", "RANKS",
           "REENTRANT", "assert_no_locks_held", "held_locks",
           "make_condition", "make_lock", "shadow_enabled"]
