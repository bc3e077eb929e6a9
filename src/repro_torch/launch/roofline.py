"""Roofline analysis from the dry-run records (port of
`repro/launch/roofline.py`).

Terms per (arch x shape) on the single-pod mesh, with NVIDIA H100 SXM
data-sheet figures in place of JAX's TPU v5e constants:
  compute    = flops per rank          / 989e12 FLOP/s (bf16 dense)
  memory     = bytes accessed per rank / 3.35e12 B/s   (HBM3)
  collective = collective bytes / rank / 50e9 B/s      (one card's share of
               400 Gb/s NDR InfiniBand: a 16-rank "model" or "data" axis
               crosses nodes of 8 cards; result-shape sum over all-gather /
               all-reduce / reduce-scatter / all-to-all / permute)

No scan correction: JAX costs a `lax.scan` body once and recovers the
per-layer costs from L = 1 and L = 2 lowers, while the port's eager trace
(`launch.dryrun`) runs and counts every layer, so `scan_corrected` is
False on every row.  The DPC cells' fixpoint loops are traced one round
each (as XLA costs a `while` body once): their terms are PER DOUBLING
ROUND (noted in the record).

  PYTHONPATH=src python -m repro_torch.launch.roofline         # full table
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch kimi-k2-1t-a32b
"""
from __future__ import annotations

import argparse
import json
import os

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9


def _load(out_dir, arch, shape):
    p = os.path.join(out_dir, f"{arch.replace('-', '_')}__{shape}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _metrics(rec):
    return {
        "flops": rec["cost"].get("flops", 0.0),
        "bytes": rec["cost"].get("bytes accessed", 0.0),
        "coll": float(rec["collectives"]["total"]),
        "transc": rec["cost"].get("transcendentals", 0.0),
    }


def model_flops(arch, shape_name, shape, n_devices):
    """6*N*D train / 2*N*D serving (the assignment's definition), N = active
    params; LM family only (None for the others)."""
    from repro_torch import configs
    mod = configs.get(arch)
    if mod.FAMILY != "lm":
        return None
    cfg = mod.full_config()
    n_act = cfg.n_active_params()
    if shape["kind"] == "train":
        d = shape["batch"] * shape["seq"]
        total = 6 * n_act * d
    elif shape["kind"] == "prefill":
        total = 2 * n_act * shape["batch"] * shape["seq"]
    else:  # decode: one token per sequence
        total = 2 * n_act * shape["batch"]
    return total / n_devices


def analyze_cell(arch, shape_name, rec):
    """One roofline row from a dry-run record."""
    from repro_torch import configs
    mod = configs.get(arch)
    shape = mod.SHAPES[shape_name]
    n_dev = 1
    for v in rec["mesh_shape"].values():
        n_dev *= v
    m = _metrics(rec)
    t_comp = m["flops"] / PEAK_FLOPS
    t_mem = m["bytes"] / HBM_BW
    t_coll = m["coll"] / LINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape_name, shape, n_dev)
    ratio = (mf / m["flops"]) if (mf and m["flops"]) else None
    bound = max(terms.values())
    roofline_frac = (mf / PEAK_FLOPS) / bound if (mf and bound) else None
    return {
        "cell": f"{arch}:{shape_name}", "family": mod.FAMILY,
        "hlo_flops_dev": m["flops"], "hlo_bytes_dev": m["bytes"],
        "coll_bytes_dev": m["coll"], **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_dev": mf, "useful_flops_ratio": ratio,
        "roofline_fraction": roofline_frac,
        "scan_corrected": False,
        "note": rec.get("note", ""),
    }


def fmt_table(rows):
    hdr = ("| cell | compute s | memory s | collective s | dominant | "
           "MODEL/HLO | roofline frac |\n|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        ratio = f"{r['useful_flops_ratio']:.2f}" \
            if r["useful_flops_ratio"] else "—"
        frac = f"{r['roofline_fraction']:.3f}" \
            if r["roofline_fraction"] else "—"
        out.append(
            f"| {r['cell']} | {r['compute_s']:.4f} | {r['memory_s']:.4f} | "
            f"{r['collective_s']:.4f} | **{r['dominant']}** | {ratio} | "
            f"{frac} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--dryrun-dir", default="experiments/dryrun/pod256")
    ap.add_argument("--out", default="experiments/roofline/roofline.json")
    args = ap.parse_args(argv)

    from repro_torch.launch.cells import all_cells
    rows = []
    for arch, shape_name in all_cells():
        if args.arch and arch not in (args.arch,
                                      args.arch.replace("-", "_")):
            continue
        if args.shape and shape_name != args.shape:
            continue
        rec = _load(args.dryrun_dir, arch, shape_name)
        if rec is None:
            print(f"[roofline] missing dry-run for {arch}:{shape_name}")
            continue
        row = analyze_cell(arch, shape_name, rec)
        rows.append(row)
        print(f"[roofline] {row['cell']}: comp={row['compute_s']:.4f}s "
              f"mem={row['memory_s']:.4f}s coll={row['collective_s']:.4f}s "
              f"-> {row['dominant']}"
              + (f" frac={row['roofline_fraction']:.3f}"
                 if row['roofline_fraction'] else ""), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    with open(args.out.replace(".json", ".md"), "w") as f:
        f.write(fmt_table(rows) + "\n")
    print(f"[roofline] wrote {len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
