"""Nothing under spcbench/ imports JAX or the JAX package ``repro``;
names are compared whole, as ``repro_torch`` begins with ``repro``."""

import ast

import pytest

from conftest import ROOT
from spcbench.harness import FORBIDDEN, forbidden_modules

SOURCES = sorted((ROOT / "spcbench").rglob("*.py"))


def top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports_no_jax(path):
    assert not set(top_names(path)) & set(FORBIDDEN)


def test_forbidden_names_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core",
                              "reprox", "jaxtyping"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla",
                              "flax", "numpy"]) == [
        "flax", "jax", "jaxlib.xla", "repro.core"]
