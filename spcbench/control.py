"""The control of a cell's comparison, at the cell's own size.

    python3 spcbench/control.py --workload <name> --seeds 1,2,3

Draws the graph, the traffic and the judged sample from each seed as a
run does, puts the reference counting in a lower precision in the
program's place (int32, the nearest below the int64 that the
configurations state, and float32, which the TPU kernel counts in),
judges it as a run judges the program, and prints one JSON line of the
numbers it reads.  An insert cell's control is read on the graph after
the mix's ``window_tickets``, about what a window applies.  It needs no
card and runs no part of the program.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent), str(HERE.parent / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

import numpy as np  # noqa: E402

from spcbench.check import CONTROL_DTYPES, verdict  # noqa: E402
from spcbench.harness import Cell, draw  # noqa: E402
from spcbench.reference.spc_bfs import Graph  # noqa: E402


def reading(root: Path, name: str, seed: int) -> list:
    """The control's numbers for one seed, one entry a precision, each
    with the verdict a run would get."""
    n, _, kind = draw(Cell(root, name), seed)
    if hasattr(kind, "window_tickets"):
        kind.applied = kind.warmup + kind.window_tickets
    graph = Graph(n, kind.final_edges())
    out = []
    for dtype in CONTROL_DTYPES:
        numbers, checked = kind.control(graph, dtype)
        out.append({"seed": seed, "count_dtype": np.dtype(dtype).name,
                    "pairs_checked": checked, **numbers,
                    "correct": verdict(numbers, checked)})
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    out = [r for s in args.seeds.split(",")
           for r in reading(HERE.parent, args.workload, int(s))]
    print(json.dumps({"workload": args.workload, "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
