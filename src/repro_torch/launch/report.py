"""Tables from the dry-run records (port of `repro/launch/report.py`).

  PYTHONPATH=src python -m repro_torch.launch.report [dryrun] [ROOT]
"""
from __future__ import annotations

import json
import os
import sys


def dryrun_table(root="experiments/dryrun"):
    rows = []
    for mesh in ("pod256", "pod2x256"):
        d = os.path.join(root, mesh)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f)) as fh:
                r = json.load(fh)
            rows.append(r)
    by_cell = {}
    for r in rows:
        by_cell.setdefault(r["cell"], {})[r["mesh"]] = r
    out = ["| cell | mesh | state+temp GiB/dev | HLO GFLOP/dev | "
           "coll MiB/dev | #coll | compile s |",
           "|---|---|---|---|---|---|---|"]
    for cell in sorted(by_cell):
        for mesh in ("pod256", "pod2x256"):
            r = by_cell[cell].get(mesh)
            if not r:
                continue
            m = r["memory"]
            gib = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) \
                / 2**30
            out.append(
                f"| {cell} | {mesh} | {gib:.2f} | "
                f"{r['cost'].get('flops', 0) / 1e9:.1f} | "
                f"{r['collectives']['total'] / 2**20:.0f} | "
                f"{r['collectives']['n_collectives']} | "
                f"{r['compile_s']:.0f} |")
    return "\n".join(out)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "dryrun"
    if what == "dryrun":
        print(dryrun_table(*sys.argv[2:3]))
