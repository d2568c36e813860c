"""``python -m repro_torch.analysis`` -- the scanner entry point / CI gate.

Usage::

    python -m repro_torch.analysis [paths ...]    # default: src
    python -m repro_torch.analysis --baseline B src tests
    python -m repro_torch.analysis --write-baseline src
    python -m repro_torch.analysis --self-test    # per-rule fixtures
    python -m repro_torch.analysis --list-rules

Findings print as ``file:line rule-id message``.  Exit codes: 0 clean
(or everything baselined/ignored), 1 unbaselined findings, 2 usage or
internal error.  ``__pycache__`` and ``fixtures`` directories are
skipped (the fixture corpus contains deliberate violations; it is
exercised by ``--self-test`` and ``tests/analysis/`` instead).

The fixture corpus is the reference's, ``tests/analysis/fixtures``, read
in place: one command gives the same output in both packages.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import lockorder, rules
from repro_torch.analysis.findings import Finding, sort_findings

_SKIP_DIRS = {"__pycache__", "fixtures", ".git", ".pytest_cache"}

_DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                 "baseline.json")


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for name in sorted(files):
                if name.endswith(".py"):
                    out.append(os.path.join(root, name))
    return out


def scan_files(files: Sequence[str]) -> Tuple[List[Finding], List[str]]:
    """Parse + run all rules.  -> (findings after inline ignores,
    parse-error messages)."""
    modules: List[Tuple[str, ast.Module]] = []
    ignores: Dict[str, Dict[int, Set[str]]] = {}
    findings: List[Finding] = []
    errors: List[str] = []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as exc:
            errors.append(f"{path}: {exc}")
            continue
        modules.append((path, tree))
        ignores[path] = baseline_mod.inline_ignores(source)
        findings.extend(rules.run(path, tree))
    # the lock analyses link call edges across every scanned module
    findings.extend(lockorder.analyze(modules))
    return baseline_mod.apply_inline(findings, ignores), errors


def _fixture_root() -> Optional[str]:
    """tests/analysis/fixtures, resolved relative to this file then cwd."""
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.path.normpath(os.path.join(
            here, "..", "..", "..", "tests", "analysis", "fixtures")),
        os.path.join(os.getcwd(), "tests", "analysis", "fixtures"),
    ]
    for cand in candidates:
        if os.path.isdir(cand):
            return cand
    return None


def self_test(out=sys.stdout) -> int:
    """Every rule's bad fixture must fire it; its good fixture must not."""
    root = _fixture_root()
    if root is None:
        print("self-test: fixture directory tests/analysis/fixtures "
              "not found", file=out)
        return 2
    failures: List[str] = []
    checked = 0
    for rule in sorted(os.listdir(root)):
        rule_dir = os.path.join(root, rule)
        if not os.path.isdir(rule_dir):
            continue
        if rule not in rules.RULE_DOCS:
            failures.append(f"{rule}: fixture dir for unknown rule-id")
            continue
        for kind, want in (("bad.py", True), ("good.py", False)):
            path = os.path.join(rule_dir, kind)
            if not os.path.isfile(path):
                failures.append(f"{rule}/{kind}: missing fixture")
                continue
            found, errs = scan_files([path])
            if errs:
                failures.append(f"{rule}/{kind}: {errs[0]}")
                continue
            hits = [f for f in found if f.rule == rule]
            checked += 1
            if want and not hits:
                failures.append(
                    f"{rule}/bad.py: expected >=1 '{rule}' finding, "
                    f"got none (other findings: "
                    f"{sorted({f.rule for f in found})})")
            elif not want and hits:
                failures.append(
                    f"{rule}/good.py: expected no '{rule}' findings, "
                    f"got {len(hits)}: {hits[0].format()}")
    missing = sorted(set(rules.RULE_DOCS) -
                     {d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d))})
    for rule in missing:
        failures.append(f"{rule}: no fixture directory")
    for msg in failures:
        print(f"self-test FAIL {msg}", file=out)
    print(f"self-test: {checked} fixture checks, "
          f"{len(failures)} failures", file=out)
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None,
         out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency lock-order + trace-safety analyzer")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to scan (default: src)")
    parser.add_argument("--baseline", default=_DEFAULT_BASELINE,
                        help="fingerprint baseline JSON "
                             "(default: the shipped, empty baseline)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record current findings into --baseline "
                             "and exit 0")
    parser.add_argument("--self-test", action="store_true",
                        help="check every rule against its bad/good "
                             "fixtures")
    parser.add_argument("--list-rules", action="store_true",
                        help="print rule-ids with one-line docs")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(rules.RULE_DOCS.items()):
            print(f"{rule:22s} {doc}", file=out)
        return 0
    if args.self_test:
        return self_test(out=out)

    paths = args.paths or ["src"]
    files = collect_files(paths)
    if not files:
        print(f"no python files under {paths}", file=out)
        return 2
    findings, errors = scan_files(files)
    for err in errors:
        print(f"parse-error {err}", file=out)

    if args.write_baseline:
        n = baseline_mod.save(args.baseline, findings)
        print(f"wrote {n} fingerprints to {args.baseline}", file=out)
        return 0

    known: Set[str] = set()
    if os.path.isfile(args.baseline):
        try:
            known = baseline_mod.load(args.baseline)
        except (ValueError, OSError) as exc:
            print(f"baseline error: {exc}", file=out)
            return 2
    new, old = baseline_mod.split(sort_findings(findings), known)
    for f in new:
        print(f.format(), file=out)
    summary = (f"{len(files)} files scanned, {len(new)} findings"
               + (f" ({len(old)} baselined)" if old else ""))
    print(summary, file=out)
    if errors:
        return 2
    return 1 if new else 0
