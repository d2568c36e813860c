"""Roofline report: reads the dry run's records (``launch.dryrun``) and
prints the table of the reference's ``src/repro/launch/roofline.py``,
its columns and format, over the port's records:

  compute term    = FLOPs / peak bf16 FLOP/s            (per device)
  memory term     = bytes / HBM bytes/s                 (per device)
  collective term = moved bytes / NVLink or NIC bytes/s (per device)

plus ``model_flops / FLOPs`` (the useful-compute ratio) and the dominant
term, reckoned against the H100's data-sheet rates (``launch.mesh``),
not measured.  A ``host_sync`` record shows its status where an error
record shows ``ERROR``.  The reference's ``merged`` has no counterpart:
the port's dry run has no unrolled variant to merge (eager loops count
every layer).  After the table, the seconds each cell's dry run took.
Usage:

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]
      [--out results/dryrun_torch] [--csv]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(mesh: str, out_dir: str = "results/dryrun_torch"):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, mesh, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_s(x):
    if x is None:
        return "-"
    return f"{x:.2e}"


def table(rows, md=True):
    hdr = ["arch", "shape", "compute_s", "memory_s", "collective_s",
           "dominant", "useful/HLO", "temp_GiB", "status"]
    lines = []
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    else:
        lines.append(",".join(hdr))
    for r in rows:
        if r["status"] != "ok":
            vals = [r["arch"], r["shape"], "-", "-", "-", "-", "-", "-",
                    "host_sync" if r["status"] == "host_sync" else "ERROR"]
        else:
            ratio = r.get("useful_flops_ratio")
            vals = [
                r["arch"], r["shape"],
                fmt_s(r.get("compute_term_s")),
                fmt_s(r.get("memory_term_s")),
                fmt_s(r.get("collective_term_s")),
                r.get("dominant_term", "-"),
                f"{ratio:.3f}" if ratio else "-",
                f"{r['memory'].get('temp_size_in_bytes', 0) / 2**30:.2f}",
                "ok",
            ]
        if md:
            lines.append("| " + " | ".join(str(v) for v in vals) + " |")
        else:
            lines.append(",".join(str(v) for v in vals))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.out)
    print(f"### Roofline table ({args.mesh}, {len(rows)} cells; H100 "
          f"data-sheet rates, reckoned, not measured)\n")
    print(table(rows, md=not args.csv))
    print("\nseconds each dry run took (dry_s):",
          ", ".join(f"{r['arch']}/{r['shape']} {r['dry_s']:.1f}"
                    for r in rows if "dry_s" in r))


if __name__ == "__main__":
    main()
