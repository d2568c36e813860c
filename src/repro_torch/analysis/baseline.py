"""Suppressions: inline ignores + a fingerprint baseline file.

Two mechanisms, with different intents:

* **Inline ignore** -- ``# analysis: ignore[rule-id]`` (or
  ``ignore[rule-a,rule-b]``, or bare ``ignore`` for all rules) on the
  finding's line.  For *intentional* exceptions, reviewed in place (a
  documented lock-free read, an epoch stamp for display).  The port's
  own code carries none.
* **Baseline file** -- JSON list of finding fingerprints
  (``path::rule::context::message``, no line numbers so unrelated edits
  don't churn it).  For *inherited debt* when enabling a new rule over
  an old tree: ``--write-baseline`` records today's findings, the gate
  fails only on new ones, and the file is burned down over time.  The
  shipped ``baseline.json`` is empty: the port scans clean.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

_IGNORE_RE = re.compile(
    r"#\s*analysis:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")

#: sentinel for "all rules ignored on this line"
ALL = "*"


def inline_ignores(source: str) -> Dict[int, Set[str]]:
    """Map line number -> set of ignored rule-ids (ALL = every rule)."""
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[lineno] = {ALL}
        else:
            out[lineno] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
    return out


def apply_inline(findings: Iterable[Finding],
                 ignores_by_path: Dict[str, Dict[int, Set[str]]],
                 ) -> List[Finding]:
    kept = []
    for f in findings:
        rules = ignores_by_path.get(f.path, {}).get(f.line)
        if rules and (ALL in rules or f.rule in rules):
            continue
        kept.append(f)
    return kept


def load(path: str) -> Set[str]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list) or \
            not all(isinstance(x, str) for x in data):
        raise ValueError(
            f"baseline {path}: expected a JSON list of fingerprints")
    return set(data)


def save(path: str, findings: Iterable[Finding]) -> int:
    prints = sorted({f.fingerprint for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(prints, fh, indent=2)
        fh.write("\n")
    return len(prints)


def split(findings: Sequence[Finding], baseline: Set[str],
          ) -> Tuple[List[Finding], List[Finding]]:
    """-> (new findings, baselined findings)."""
    new, old = [], []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
