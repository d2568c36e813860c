"""Finding record + stable fingerprints (the baseline unit)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding, formatted as ``file:line rule-id message``.

    ``context`` is the enclosing qualname (``Class.method`` or
    ``<module>``); it feeds the fingerprint so baselines survive line
    drift from unrelated edits.
    """

    path: str
    line: int
    rule: str
    message: str
    context: str = "<module>"

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline mechanism."""
        return f"{self.path}::{self.rule}::{self.context}::{self.message}"


def sort_findings(findings):
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
