"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
tiny size, which the harness runs with ``device="cpu"``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: The tiny sizes: every configuration and mix keeps its keys.
TINY_CONFIG = {"n": 160, "m": 640, "alpha": 0.8, "i0": 3.0}
TINY_TRAFFIC = {"scan": {"batch_pairs": 2048, "trace_requests": 3,
                         "check_pairs_per_batch": 512},
                "insert": {"events_per_ticket": 2, "tickets": 64}}


def tiny_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``spcbench/`` copied to ``dest`` with every
    configuration and mix cut to the tiny sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "spcbench", dest / "spcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (dest / "spcbench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(TINY_CONFIG)
        p.write_text(json.dumps(cfg))
    for p in (dest / "spcbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(TINY_TRAFFIC[mix["kind"]])
        p.write_text(json.dumps(mix))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("spcbench_tiny"))


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
