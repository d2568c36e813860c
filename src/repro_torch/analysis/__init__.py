"""Lock factories with the canonical lock names (the port's own copy).

Every lock of the port is created through ``make_lock`` with a name
from ``hierarchy.HIERARCHY``; with ``REPRO_SHADOW_LOCKS=1`` the
factories hand out instrumented locks that enforce the hierarchy.
"""

from repro_torch.analysis.shadow import (LockHierarchyViolation,
                                         assert_no_locks_held, held_locks,
                                         make_condition, make_lock,
                                         shadow_enabled)

__all__ = ["LockHierarchyViolation", "assert_no_locks_held", "held_locks",
           "make_condition", "make_lock", "shadow_enabled"]
