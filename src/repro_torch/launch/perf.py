"""Perf hill-climbing (port of `repro/launch/perf.py`): dry-run optimised
variants of the chosen cells on the single-pod mesh and record them beside
the baseline records (`launch.dryrun`).  The variants are JAX's cells,
tags and transforms on the port's config fields, those that change what
the port runs; their hypotheses are the port's.

  PYTHONPATH=src python -m repro_torch.launch.perf [--cell kimi_k2_1t:train_4k]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.launch.dryrun import MESHES, fake_world, run_cell
from repro_torch.launch.mesh import make_production_mesh

# (cell, variant_tag, hypothesis, cfg_transform)
VARIANTS = []


def _v(cell, tag, hypothesis, transform):
    VARIANTS.append((cell, tag, hypothesis, transform))


# The port runs eagerly on H100s of 80 GB: a rank's args + temp is the peak
# live set of rank 0's step, and every collective is one the port issues.
# Of JAX's eleven variants, the four that differ from the baseline or from
# shardmap_bf16mom_remat only in `moe.dispatch` are left out: the port's
# "local" dispatch with dp_shards = dp, its "shard_map" and its "global"
# one (which the cells run as "shard_map") are one partition, so those
# variants trace a program already recorded.

# --- 1. kimi-k2-1t:train_4k: the scale cell ---------------------------------

_v("kimi_k2_1t:train_4k", "shardmap_bf16mom_remat",
   "bf16 AdamW moments halve the optimizer state, a share of a rank's "
   "arguments; torch.utils.checkpoint around the attention call and the "
   "loss keeps only their inputs for the backward, so the temp falls and "
   "the FLOPs rise by the recomputed forward. Collective bytes stay: "
   "the regions issue no collective. The rank then fits 80 GB or not.",
   lambda cfg: dataclasses.replace(
       cfg, moe=dataclasses.replace(cfg.moe, dispatch="shard_map"),
       opt_moment_dtype=torch.bfloat16, remat_attn=True, remat_loss=True))

# --- 2. dimenet:ogb_products: the largest GNN live set ----------------------

_v("dimenet:ogb_products", "chunked_triplets",
   "The triplet messages (T, n_bilinear, d) are built for all of a rank's "
   "triplets at once. 64 chunks keep 1/64 of them live at a time, with the "
   "same gathers; the temp falls only if that buffer is the peak.",
   lambda cfg: dataclasses.replace(cfg, triplet_chunks=64))

_v("dimenet:ogb_products", "chunked_bf16_msgs",
   "On top: the triplet messages in bf16 halve their bytes and those of "
   "the node-row all-gathers that carry them, so the temp and the "
   "collective bytes both fall.",
   lambda cfg: dataclasses.replace(cfg, triplet_chunks=64,
                                   msg_dtype=torch.bfloat16))

# --- 3. stablelm-12b:train_4k: the dense training cell ----------------------

_v("stablelm_12b:train_4k", "remat_attn_loss",
   "Checkpointing the attention call and the chunked loss recomputes them "
   "in the backward: FLOPs rise by those forwards. The eager peak is "
   "reached inside a layer's backward, so the temp may not fall.",
   lambda cfg: dataclasses.replace(cfg, remat_attn=True, remat_loss=True))

_v("stablelm_12b:train_4k", "remat_bf16mom",
   "On top: bf16 moments halve the AdamW state in a rank's arguments.",
   lambda cfg: dataclasses.replace(cfg, remat_attn=True, remat_loss=True,
                                   opt_moment_dtype=torch.bfloat16))

_v("stablelm_12b:train_4k", "tp_only_params",
   "Without FSDP a rank holds its whole tensor-parallel share of the "
   "weights and moments (arguments up) and gathers no layer over "
   "\"data\" (collective bytes down by those all-gathers).",
   lambda cfg: dataclasses.replace(cfg, remat_attn=True, remat_loss=True,
                                   opt_moment_dtype=torch.bfloat16,
                                   fsdp=False))

# --- 4. the paper's own workload --------------------------------------------

_v("dpc_grid:cc_1024", "no_mask_gather",
   "The CC exchange all-gathers the boundary labels and masks, but a mask "
   "is labels >= 0: dropping its gather cuts the one communication "
   "phase's bytes with the same labels.",
   lambda cfg: dataclasses.replace(cfg, gather_mask=False))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    multi_pod, size = MESHES["pod256"]
    results = []
    with fake_world(size):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        for cell, tag, hypothesis, tr in VARIANTS:
            if args.cell and cell != args.cell:
                continue
            arch, shape = cell.split(":")
            print(f"[perf] {cell} :: {tag}\n  hypothesis: {hypothesis}",
                  flush=True)
            try:
                rec = run_cell(arch, shape, mesh, "pod256", False, args.out,
                               cfg_transform=tr, tag=tag)
                rec["hypothesis"] = hypothesis
                rec["variant"] = tag
                with open(os.path.join(
                        args.out, f"{arch}__{shape}__{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=1)
                results.append(rec)
            except Exception as e:  # noqa: BLE001
                print(f"[perf] FAIL {cell}:{tag}: {e}", flush=True)
    print(f"[perf] done: {len(results)} variants recorded")


if __name__ == "__main__":
    main()
