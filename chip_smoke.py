#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA device of compute capability 9.0 or higher (Hopper) and nvcc;
imports neither jax nor the JAX package.  Phases, each printed with its
seconds:

  1. device: name, capability, `nvidia-smi` name and power limit;
  2. build: nvcc builds every kernel of the port from the checkout;
  3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
     the card, pointers and rounds exactly equal (ragged 97x61x43 cases,
     int64 ids, long chains in one slab -- serpentine and z-ramp order
     fields both ways round, cc lines along z, `repro_torch.data.chains` --
     and the 512^3 grid);
  4. main path at 512^3 (configs `grid_512` / `cc_512`): Perlin field ->
     order field -> an `ms` query and a `cc` query on the top-10% mask
     through `repro_torch.topology.submit`, with the kernel launch counters
     set to 0 just before and read just after;
  5. checks that do not trust the kernel: the plain init-only path on the
     card, scipy.ndimage.label on the host, extrema, segment counts;
  6. numbers: warm query times, kernel and plain times beside the bound,
     peak device memory, rounds and counts, and a torch.profiler breakdown
     of one kernel launch of each mode (with its count of device-to-host
     copies, which must be one: the round count read back) and of one
     query of each kind; the previous design's times (synchronous doubling
     rounds), read in an earlier run, are printed on a line of their own;
  7. the four stand-alone kernels behind `repro_torch.kernels.ops`
     (`steepest_neighbor`, `block_pathcompress`, `embedding_bag` ->
     `segment_bag`, `flash_attention`): each kernel against its plain
     version on ragged cases and at full size (the grid_512 order field and
     its steepest pointers; BST's multihot table at the serve_bulk batch;
     llama3.2-1b attention widths at 32k, batch cut from 32 to 1, bf16 on
     the tensor-core kernel and f32 on the one with P V on the tensor cores
     in 3xTF32; D = 320 on the CUDA-core kernel in both dtypes), then the
     `ops` path with every launch counter set to 0 just before and read
     just after, its results checked against the compared ones, and the
     kernel, plain, bound and library times (SDPA's flash backend for bf16,
     its memory-efficient one for f32), attention's TFLOP/s and the two
     tensor-core kernels' ptxas registers and spills.  The two pointer
     kernels and both bags also carry `device_ms`, their own device time
     in a profiler window (median of 21 launches); `steepest_neighbor` at
     connectivity 26 on the same field is checked and timed on a line of
     its own.  The bags print the worst element's share of their limit and
     a per-reference figure beside the bound (context, not a bound), and
     BST's own calls (`models/bst.py`: one a multihot field, field f's ids
     in [f * 500,000, (f + 1) * 500,000) plus -1 pads) at serve_bulk and
     serve_p99, both dtypes, each held to the plain version, with event
     time, device time (the two fields in turns) and bound; then the
     ptxas registers and spills of every bag instance (the four 16-byte
     instances must not spill);
  8. the graph domain (`configs/dpc_graph.py`) through
     `repro_torch.topology.submit(domain="graph")`: the Freudenthal tet mesh
     of a 256^3 grid (233,311,230 directed edges, built on the card) with
     an `ms` query, a `cc` query on the top-10% mask and a pure-geometry
     `cc` (mask = ones), and `random_1m` (`cc` with mask = ones and with a
     top-10% mask), every launch count read as 0 after them (the graph path
     has no kernel); graph ms and cc held to the grid path at connectivity
     14 (which launches the fused kernel), geometry labels to n - 1,
     `random_1m` to scipy's connected components; per-query peak device
     memory, meta counts, warm query times and a profile of one graph ms
     and one graph cc query;
  9. the distributed grid backend (`repro_torch.core.distributed`), built
     kernels only (the ranks load what phase 2 built): 9a one rank over
     NCCL, layout (1, 1, 1), on phase 4's inputs (one 514^3 extended
     block): ms (both manifolds) and cc in both table modes, labels equal
     to phase 4's, peaks, warm times beside the pure queries and a profile
     of one cc call; then `topology.submit(backend="distributed")` for cc,
     both manifolds, ms and a threshold sweep over the field's 0.6-0.9
     quantiles (one batched call), each equal to the direct calls and the
     pure routes, the sweep's fused launches equal to the plain version,
     and the batched sweep's warm time beside four single calls; 9b two
     ranks sharing the card over gloo (NCCL refuses two ranks on one card),
     the same generator at 1024x512x512, layout (2,), a 512^3 block a
     rank: labels gathered to this process equal the pure path's, both
     ranks' stats equal, times with the caveat that two processes
     time-share the card and gloo stages every exchange through the host;
     a batched cc of two masks equals its single calls and issues as many
     shifts, all-gathers and all-reduces as one; 9c eight ranks over gloo,
     97x61x43 and 128^3 over (2, 2, 2), connectivity 6 and 26, both table
     modes, the mask gathered and not: each rank's labels equal the pure
     path's, stats equal their closed forms, and each rank's ghost-masked
     fused launch equals the plain version.  The fused kernel's launches
     on these paths go into the kernels line as `launches_distributed`;
 10. the distributed graph backend (`repro_torch.core.distributed_graph`),
     gloo ranks sharing the card: 10a phase 8's tet mesh over two
     contiguous partitions, cc of the top-10% mask and of mask = ones in
     both table modes, the mask gathered and not, labels assembled in this
     process equal to phase 8's, each rank's GraphDecomp host time and
     peak host and device memory; 10b random_1m over eight partitions
     (every partition adjacent to every other), a batch of four masks in
     both table modes equal to its single calls, the first two equal to
     phase 8's.  No kernel launches there;
 11. the serving engine (`repro_torch.serve`) at the full widths of
     `configs/serve_topology.py` (extents 96^3, 97x61x43, 64x96x48 and
     101x53x37, its query mix, sweep_k 4, max_batch 64), 64 requests of its
     synthetic workload: 11a `TopologyEngine.submit_batch` cold, then warm
     (no build, a hit on every bucket), every result == `submit_many` bit
     for bit, fused launches == the grid buckets' capacity sum, requests/s,
     hit rate, pad fraction, executables, peak device memory and a profile
     of a warm pass of the first 16; then, outside the launch windows,
     every slot of a pass as stacked and padded (the real payloads in
     their pow2 layouts and the all-inert dummy slots) through the fused
     kernel and its plain version, pointers and rounds equal; 11b the async plane on the same trace
     (open-loop arrivals, VirtualClock with execution time charged): every
     handle == `submit_many`, flush reasons summing to the executions,
     deadline hit rate and latency percentiles; 11c overload at 4x 11a's
     warm rate (queue depth 24, shed "hopeless", then "never" on the same
     trace): completed handles == `submit_many`, the rest typed Overloaded or
     DeadlineShed; 11d the distributed engine on one NCCL rank at phase
     4's 512^3 block, an ms and 9a's K = 4 sweep in one submit_batch ==
     the facade's routes and phase 4's pure ms, timed beside the facade's
     two calls; 11e eight gloo ranks sharing the card, 97x61x43 over
     (2, 2, 2): the sync engine == each rank's facade in all four
     (connectivity, table mode) sets, the async engine in the first, where
     a table_max_iter=1 request fails alone, the multi-rank clock guard,
     and the ghost-masked kernel == plain on each rank's real and dummy
     block.  The fused kernel's launches there go into the kernels line as
     `launches_serve`, and the errors of 11a's and 11e's comparisons into
     its `max_abs_err`.

 12. LM serving (`repro_torch.models.lm`, `repro_torch.launch.serve`):
     llama3.2-1b's `full_config()` in bf16 (1,498,482,688 parameters,
     weights drawn on the card from a seed), 4 prompts of 32,768
     (prefill_32k's sequence, batch cut from 32 to 4) and 16 greedy tokens
     through the launcher's LM mode (a warm-up and three timed
     generations), flash_attention counts set to 0 just before and read
     just after (once a layer a prefill); then one prefill and one
     decode step, each profiled, counted apart (16 and 0 launches), layer 0's
     kernel launch at the served shape held to the plain version, and the
     whole model at batch 1 x 2048 with the kernel held to the same model
     with the plain attention (and both to the fp32 model): logits and
     greedy tokens;
 13. BST serving (`repro_torch.models.bst`): `configs/bst.py`'s
     `full_config()` in fp32 (4,194,304 item rows), `forward` at serve_p99
     (512) and serve_bulk (262,144), two segment_bag launches each, bags
     and logits held to the model with the bags' plain version;
     `retrieval_step` at retrieval_cand (1 x 1,000,000, top 100, no bag
     launch), ids held to a top-k on the host under JAX's tie rule; warm
     times and peaks.  Then the launcher's topology mode at its smoke
     config, its engine stats on the card equal to the CPU's.  The
     attention and bag rows of the kernels line carry `launches_lm` and
     `launches_bst`;
 14. MoE serving (`repro_torch.models.lm`'s MoE FFN): 14a
     deepseek-moe-16b's `full_config()` in bf16 (16,879,568,896
     parameters, 33.8 GB, all 28 layers, weights drawn on the card) through
     the launcher's LM mode, 4 prompts of 4,096 (its context length) and 16
     greedy tokens, flash_attention counts set to 0 just before and read
     just after (once a layer a prefill, never in decode); one prefill and
     one decode step counted apart; layer 0's attention launch at the
     served shape held to plain; the MoE check on layer 0's own input of
     one prompt: the card's top-6 and dispatch table == a host recount, and
     256 sampled tokens' output == a per-expert fp32 loop over their kept
     and shared experts; 14b kimi-k2-1t-a32b at full width with its 61
     layers cut to 1 (38.8 GB): a 1 x 2,048 prefill and 4 decode steps (384
     experts top-8, GQA 64/8, head dim 112 on `flash_tc`), the layer's
     launch held to plain, the same MoE check.  The bf16 attention row
     carries `launches_moe`;
 15. training: 15a the kernels' gradients (`kernels.ops`' autograd
     Functions: the kernel's forward, `attention_backward` /
     `bag_backward` in PyTorch ops) against autograd through the plain
     versions, attention at llama3.2-1b's layer (1 x 32 heads, 8 kv, 4,096,
     D 64, causal) in bf16 and fp32, the bag at BST's serve_bulk ids; 15b
     `repro_torch.launch.train.main` on llama3.2-1b's `full_config()`
     (bf16 params, fp32 moments, remat), 4 x 2,048, 20 steps: the loss
     falling, 32 attention launches a step (16 forward, 16 in remat's
     recompute), step time, tokens/s, peak; 15c the smoke config with
     `--chaos` as `examples/train_lm.py` runs it: one restart, the restored
     state == the checkpoint's arrays bit for bit, eval loss < 4; 15d
     deepseek-moe-16b at full width cut to 2 layers, 3 AdamW steps on one 2
     x 2,048 batch: gradients finite, the router's and experts' non-zero,
     the loss falling; 15e one BST step at `full_config()`, batch 4,096:
     two bag launches, the table's gradient on 64 rows == a host sum of
     the bags' gradients.  The attention rows and the f32 bag row carry
     `launches_train`;
 16. the GNN substrate (`repro_torch.models.gnn`, no kernel of its own),
     each model at its `full_config()` widths, parameters drawn on the
     host and copied to the card: 16a GAT gat-cora on `cora_like()` (2,708
     nodes, 10,556 edges, 1,433 features), and GAT adapted to minibatch_lg
     (602 features, 41 classes) on one `sampled_batch` (1,024 seeds,
     fanouts 15 and 10, padded to 169,984 nodes and 337,920 edges) of
     `random_csr(232,965, 492)` (~114.6 M directed edges, built on the
     host, its seconds printed); 16b SchNet and DimeNet (triplet_chunks 1
     and 4) on `molecule_batch(128, 30, 64)`; 16c MeshGraphNet (15 layers,
     remat) on `mesh_grid_graph(512, 512)` (262,144 nodes, 1,568,770
     directed edges); for each, the card's forward == the port on the CPU
     within GNN_FWD_TOL, four AdamW steps with the loss falling, warm
     forward and step ms, peak; a profile of one 16c training step; 16d
     `examples/gnn_cc_pipeline_torch.py` (20,000-node graph, 10 steps) on
     the card, its per-step DPC component counts == the CPU run's.  Every
     launch counter reads 0 over the phase; each kernel row carries it as
     `launches_gnn`;
 17. the LM on a mesh (`repro_torch.runtime.meshctx`, `models.lm`'s
     sharded paths) on four gloo ranks sharing the card, each sub-phase
     held to the same work on one rank in this process: 17a one AdamW
     step of llama3.2-1b at full width (16 layers cut to 4, bf16) at 4 x
     2,048 on mesh (2, 2) (FSDP x TP, sequence parallel): the loss, the
     gradient norm, every gathered gradient leaf, every gathered updated
     parameter and its update's signs leaf by leaf (DLM_* bounds), each
     rank holding 1/4 of every FSDP x TP leaf, 8 `flash_tc` launches a
     rank (one a layer and one in remat's recompute), each == plain on
     its own inputs; step ms and peak a rank; 17b llama3.2-1b whole, 4
     greedy decode steps against a 524,288-position cache (17.18 GB bf16,
     drawn from a seed with K at DLM_LONG_KSCALE sigma, no prefill) whose
     sequence is split over the four ranks (`LONG_CACHE_LOGICAL` on mesh
     (4, 1), 4.29 GB a rank): logits and tokens == one rank's, a new draw
     of any one slice moving the one-rank logits beyond the gate, the new
     tokens' K and V read back on the one rank holding them; 17c
     deepseek-moe-16b at full width cut to 2 layers, a 2 x 2,048 prefill
     through the shard_map dispatch on (2, 2) == the one-rank "local"
     dispatch with dp_shards 2: in fp32, kept and dropped slots equal; in
     bf16 on the ranks' experts, slots equal and logits within
     DLM_MOE_BF16_ULPS, the routings' flips within a budget; 17d
     `examples/quickstart_torch.py` and `examples/graph_cc_torch.py` on
     two gloo ranks sharing the card.  The attention rows carry the
     launches as `launches_distributed_lm`, the fused rows 17d's
     single-device launches as `launches_examples`;
 18. the launch tools (`repro_torch.launch.cells` / `dryrun`) and the
     sharded BST and GNNs: 18a JAX's six dry-run test cells at full
     configs on their meshes, each in a process of its own (a fake
     process group of 256 or 512 ranks, rank 0's step on the meta
     device): per-rank GiB, GFLOP and collective MiB, and JAX's pod-axis
     rule on kimi-k2 and stablelm-12b train_4k; 18b the dry run's args +
     temp of two one-rank cells (llama3.2-1b train_4k at 4 x 2,048 and
     dpc_grid grid_512) against the card's peak over the same step
     (LAUNCH_* bounds); 18c BST's full config on four gloo ranks sharing
     the card, mesh (2, 2): serve_bulk logits and the retrieval of 10^6
     candidates == one rank's, the bag kernel launched on every rank; 18d
     MeshGraphNet 512^2 (forward, gradients, one AdamW step's parameters)
     and GAT on phase 16's minibatch_lg batch (forward, gradients) on the
     same ranks == one rank.  Every row of the
     kernels line carries the phase's launches as `launches_launch`.

The last three lines are the `nvidia-smi` line, one JSON object describing
every kernel, and `{"ok": true, "device": {...}}`.  Any failure raises and
the exit code is not 0.
"""
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 42                      # Perlin seed of the main path
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores,
                               # taken for the kernel's 32-bit compares
# attention's rate by `flash_attention.route`, in fp32-equivalent flops:
# the dense bf16 tensor-core rate; for fp32 a third of the dense TF32 rate
# (494.7 TFLOP/s), since fp32-accurate products take three TF32 ones
# (3xTF32), the least time fp32-accurate attention can take on the card;
# fp32 outside the tensor cores, the bound of fp32 attention before it ran
# on the tensor cores
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 494.7e12 / 3,
               "float32_cuda_cores": 67e12}
RAGGED = (97, 61, 43)
# (field, flipped along y and z, shape, mode, block_x, ids): chains of up to
# ~131,000 hops (serpentine, one 512 x 512 plane a slab) and ~1,030 hops
# (z ramp), and cc lines of 512 voxels
LONG_CHAINS = (("serpentine_order", False, (8, 512, 512), "manifold", 1, None),
               ("serpentine_order", True, (8, 512, 512), "manifold", 1, None),
               ("serpentine_order", True, (4, 64, 64), "manifold", 1,
                "int64"),
               ("z_ramp_order", False, (64, 512, 512), "manifold", 8, None),
               ("z_ramp_order", True, (64, 512, 512), "manifold", 8, None),
               ("z_line_mask", False, (64, 512, 512), "cc", 8, None))
# the previous design of the fused kernel (synchronous doubling rounds, one
# host read a round): ms per launch at 512^3 on an NVIDIA H100 80GB HBM3 at
# 700 W, read by this script in an earlier run (PERF.md, run R); printed
# for reference, never part of the measured results
EARLIER_RUN_MS = {"manifold": 11.519, "cc": 10.124}
# the previous design of f32 attention (flash_fwd, a warp per query row on
# the CUDA cores) at the phase-7 shape, same card and power limit, read by
# this script in an earlier run (PERF.md, run T); printed for reference only
EARLIER_FLASH_F32_MS = 726.057
# BST (configs/bst.py): two multihot fields of 500,000 rows, embed_dim 32,
# 16 ids a bag; serve_bulk's batch, and serve_p99's for BST's own calls
BST_FIELDS, BST_FIELD_V, BST_P99 = 2, 500_000, 512
BAG_V, BAG_D, BAG_B, BAG_L = BST_FIELDS * BST_FIELD_V, 32, 262_144, 16
# llama3.2-1b (configs/llama3_2_1b.py) at prefill_32k, batch cut 32 -> 1
ATTN_B, ATTN_H, ATTN_HKV, ATTN_D, ATTN_S = 1, 32, 8, 64, 32_768
TOL = {"bfloat16": {"bag": 3e-2, "attn": 2e-2},
       "float32": {"bag": 1e-5, "attn": 2e-5}}
# Full-size bf16 attention (rtol, atol): a row that sees n random keys has
# outputs of about sqrt(e / n), ~0.013 at n = 16k, so 2e-2 would pass a
# kernel that dropped key tiles or wrote zeros.  The plain version keeps p
# in fp32; the tensor-core kernel carries it as two bf16 parts (within
# ~2^-17), so both sum in fp32 and round once to bf16 and may differ by one
# bf16 ulp (at most 2^-7 of the value): rtol 8e-3, plus atol 2e-3 near
# zero.  The run prints the worst element's share of this limit.
ATTN_BF16_FULL = (8e-3, 2e-3)
# phase 8's tet mesh: the Freudenthal edge set of a 256^3 grid (configs/
# dpc_graph.py's tet_* family at connectivity 14): 16,777,216 vertices and
# 233,311,230 directed edges.  512^3 would need 15 GB of int32 edges
# before any temporary; 256^3 is the largest cube whose query fits with a
# wide margin (PERF.md section 4)
TET_DIMS = (256, 256, 256)
# phase 9b: grid_512's generator at twice its extent along x, two ranks of
# one 512^3 block each (layout (2,)); 9c: ragged and 128^3 cases over
# (2, 2, 2) as (shape, mask probability, seed)
DIST_B_SHAPE = (1024, 512, 512)
DIST_C_CASES = ((RAGGED, 0.3, 97), ((128, 128, 128), 0.3, 128))
MODES = ("replicated", "sharded")
# 9a's threshold sweep through the facade: the field's 0.6 .. 0.9 quantiles
SWEEP_QS = (0.6, 0.7, 0.8, 0.9)
# 9b's batch: the top-10% mask and the field's top 20%
DIST_B_BATCH_Q = 0.8
# phase 10a: phase 8's tet mesh over 2 contiguous partitions, two gloo
# ranks; 10b: random_1m over 8, a batch of the masks above these quantiles
# (the first two are phase 8's: all vertices and the top 10%)
GRAPH_PARTS = 2
RANDOM_PARTS = 8
RANDOM_BATCH_QS = (None, 0.9, 0.8, 0.5)
# phase 11: the serving engine at configs/serve_topology.py's full widths,
# `SERVE_N` requests of its synthetic workload (seed `SERVE_SEED`); 11e's
# gloo ranks serve the ragged grid over (2, 2, 2) (seed `SERVE_E_SEED`)
SERVE_N = 64
SERVE_PROFILED = 16
SERVE_SEED = 0
SERVE_E_SEED = 11
SERVE_E_QS = (0.5, 0.7, 0.9)
# phase 12: llama3.2-1b's full config in bf16 at prefill_32k's sequence,
# batch cut from 32 to 4 (the run's time), LM_GEN greedy tokens; the whole
# model held to the plain attention at batch 1 x LM_CHECK_PROMPT
LM_ARCH, LM_SEED = "llama3.2-1b", 0
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK_PROMPT = 4, 32_768, 16, 2048
# phase 13: BST logits against the bags' plain version (rtol, atol): the
# bags agree within 1e-5 (fp32 sums in another order), and the MLP's
# layers, scaled 1/sqrt(fan-in), keep a perturbation's size
BST_LOGIT_TOL = (1e-4, 1e-5)
# phase 14a: deepseek-moe-16b's full config in bf16, MOE_BATCH prompts of
# its context length through the launcher, MOE_GEN greedy tokens; the MoE
# check samples MOE_SAMPLE tokens of one prompt, each held to an fp32 loop
# within MOE_BF16_TOL of its largest |output| (bf16 roundings of the
# experts' SwiGLU, the slot weight and the combine, each ~2^-9 of a value)
MOE_ARCH, MOE_SEED = "deepseek-moe-16b", 0
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_SAMPLE = 4, 4096, 16, 256
MOE_BF16_TOL, MOE_F32_TOL = 2e-2, 1e-5
# phase 14b: kimi-k2-1t-a32b at full width, 61 layers cut to the one that a
# card holds (38.8 GB in bf16), a 1 x KIMI_PROMPT prefill and KIMI_STEPS
# decode steps
KIMI_ARCH, KIMI_LAYERS, KIMI_PROMPT, KIMI_STEPS = "kimi-k2-1t-a32b", 1, 2048, 4
# phase 15a: attention gradients at llama3.2-1b's layer (ATTN_H, ATTN_HKV,
# ATTN_D) at ATTN_GRAD_S, causal; each gradient within ATTN_GRAD_TOL of its
# tensor's largest |grad| (fp32: the backward recomputes P as autograd
# through plain keeps it; bf16: the kernel's bf16 output and inputs); bag
# gradients within BAG_GRAD_TOL (fp32 atomics in another order)
ATTN_GRAD_S = 4096
ATTN_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
BAG_GRAD_TOL = 1e-5
# phase 15b: llama3.2-1b training through the launcher; 15d deepseek-moe-16b
# at full width cut to MOE_TRAIN_LAYERS of 28, MOE_TRAIN_STEPS AdamW steps
# at MOE_TRAIN_LR on one batch; 15e one BST step at BST_TRAIN_BATCH.  The
# launcher's default peak lr (3e-3) is the smoke model's: at llama3.2-1b's
# width the loss climbs once the warm-up passes ~1e-3, so 15b peaks at a
# 1B model's 3e-4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 20, 3e-4
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_LR = 2, 3, 1e-3
BST_TRAIN_BATCH = 4096
# phase 16: the GNNs at full width, parameters drawn from GNN_SEED on the
# host; the card's fp32 forward held to the CPU's within GNN_FWD_TOL of the
# output's largest |value| (segment sums by atomics in no fixed order,
# cuBLAS against the CPU's matmuls, through up to 15 residual layers);
# GNN_TRAIN_STEPS AdamW steps at GNN_LR (JAX's GNN cells' lr,
# `build_gnn_cell`; at 1e-3 DimeNet's energy loss jumps 5x on the first
# step) on one batch; MeshGraphNet on a GNN_MESH_SIDE^2 mesh
GNN_SEED, GNN_FWD_TOL, GNN_TRAIN_STEPS, GNN_LR = 0, 1e-4, 4, 1e-4
GNN_MESH_SIDE = 512
# phase 17: the distributed LM on DLM_WORLD gloo ranks sharing the card,
# mesh DLM_MESH over ("data", "model").  17a llama3.2-1b at full width,
# 16 layers cut to DLM_LAYERS, DLM_BATCH x DLM_SEQ tokens, sequence
# parallel, one AdamW step at DLM_LR against the same step on one rank.
# Gates: the loss within DLM_LOSS_TOL; the global gradient norm within
# DLM_NORM_RTOL; every gradient leaf, gathered whole, within DLM_GRAD_ULPS
# bf16 ulps of the leaf's largest |grad| (a wrong leaf is off by about
# its largest value, 128 ulps and more); every parameter within 2 lr (a
# near-zero gradient's sign may flip between the two sums) plus 2 bf16
# ulps of the larger of the two values; the update's sign equal on at
# least DLM_SIGN_SHARE of the elements that moved by more than lr / 2, in
# every leaf that has one (a wrong gradient agrees on about half; the
# norms' bf16 weights at 1.0 do not move by lr); every one of a
# rank's flash_attention launches == plain on its own inputs.
DLM_WORLD, DLM_MESH, DLM_SEED = 4, (2, 2), 17
DLM_LAYERS, DLM_BATCH, DLM_SEQ, DLM_LR = 4, 4, 2048, 1e-3
DLM_LOSS_TOL, DLM_NORM_RTOL, DLM_SIGN_SHARE = 2e-3, 1e-2, 0.99
DLM_GRAD_ULPS = 8
# 17b: llama3.2-1b at full width and depth decoding DLM_LONG_STEPS greedy
# tokens against a long_500k cache of DLM_LONG_LEN positions (batch 1),
# filled from a seed a (layer, DLM_LONG_CHUNK positions) chunk at a time,
# so a rank draws its own positions alone; the cache sequence over all
# four ranks (`lm.LONG_CACHE_LOGICAL`) on mesh (4, 1): the weights FSDP
# over "data", not split over "model", so that the one-rank decode differs
# only in the log-sum-exp merge's order (bf16 greedy tokens flip on a
# near tie).  Logits within DLM_LONG_TOL of the row's largest |logit|,
# tokens equal (each step fed the one-rank run's token).  The cache's K
# is drawn N(0, DLM_LONG_KSCALE^2), so a query's scores have a standard
# deviation near DLM_LONG_KSCALE and its softmax sits on a few positions
# spread over the ranks (at N(0, 1) it is near uniform over 524,288
# positions, each head's output near 1e-3, and no slice shows in the
# logits).  The gate's reach: step 0 again on one rank with any one
# rank's slice drawn anew must move the logits beyond DLM_LONG_TOL.  Each
# written K and V slot is read back: the positions that no longer hold
# their seeded values are exactly the 4 new tokens' in every layer, all
# on the rank that holds them, their values within DLM_LONG_TOL of the
# layer's largest written |value| of the one-rank run's.
DLM_LONG_LEN, DLM_LONG_STEPS, DLM_LONG_CHUNK = 524_288, 4, 32_768
DLM_LONG_TOL, DLM_LONG_KSCALE = 3e-2, 4.0
# 17c: deepseek-moe-16b at full width cut to DLM_MOE_LAYERS layers, a
# DLM_MOE_BATCH x DLM_MOE_SEQ prefill, shard_map dispatch on the mesh
# against the one-rank "local" dispatch with dp_shards 2.  In fp32 the
# kept and dropped slot counts are gated equal and the logits within
# DLM_MOE_TOL of the row's largest |logit|.  In bf16, the config's own
# precision, the roundings of the row-parallel sums flip top-6 near-ties,
# so the one-rank run takes the ranks' experts (its own weights for them);
# then the slot counts are equal and the logits within DLM_MOE_BF16_ULPS
# bf16 ulps of the row's largest |logit|.  The bf16 routings' flips (the
# one-rank run's own experts against the ranks') stay within
# DLM_MOE_FLIP_BUDGET of the tokens in every layer (the second layer's
# input carries the first's flipped tokens: an H100 read 0.37% and 1.88%;
# a wrong router or token block differs on most tokens), and both model
# ranks of a data shard route alike.
DLM_MOE_LAYERS, DLM_MOE_BATCH, DLM_MOE_SEQ, DLM_MOE_TOL = 2, 2, 2048, 1e-4
DLM_MOE_BF16_ULPS, DLM_MOE_FLIP_BUDGET = 8, 0.05
# 17d: the example twins on DLM_EXAMPLE_RANKS gloo ranks sharing the card
DLM_EXAMPLE_RANKS = 2
# phase 18: the launch tools.  18a: JAX's six dry-run test cells
# (`tests/test_dryrun_cells.py`) at their full configs on their meshes.
LAUNCH_CELLS = (("llama3_2_1b", "train_4k", "--single-pod"),
                ("kimi_k2_1t", "decode_32k", "--multi-pod"),
                ("gat_cora", "ogb_products", "--single-pod"),
                ("bst", "retrieval_cand", "--multi-pod"),
                ("dpc_grid", "cc_512", "--single-pod"),
                ("dpc_grid", "cc_ragged", "--single-pod"))
# 18b: the dry run's args + temp of a one-rank cell against the card's peak
# over the same step (PERF.md section 5, written before the first run): the
# LM within LAUNCH_LM_MEM_TOL of it; the DPC cell's meta trace keeps every
# compaction at its full length (`_meta.nonzero`), so its prediction is an
# upper bound, at most LAUNCH_DPC_MEM_MAX times the peak
LAUNCH_LM_BATCH, LAUNCH_LM_MEM_TOL, LAUNCH_DPC_MEM_MAX = (4, 2048), 0.15, 3.0
# 18c-d: BST and the GNNs on LAUNCH_WORLD gloo ranks sharing the card, mesh
# LAUNCH_MESH, each held to one rank (GNNs: GNN_FWD_TOL of the largest
# output; gradients LAUNCH_GRAD_TOL of each leaf's largest |grad|, the
# GNNs' gradient gate; MeshGraphNet's AdamW step: every parameter within
# 2 GNN_LR of one rank's, as a near-zero gradient's sign may flip between
# the two sums, and at most LAUNCH_FLIP_SHARE of the updates flipped)
LAUNCH_WORLD, LAUNCH_MESH, LAUNCH_SEED = 4, (2, 2), 23
LAUNCH_GRAD_TOL, LAUNCH_FLIP_SHARE = 1e-4, 1e-3


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s", flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps):
    """Median over `reps` calls of fn's time on the card: CUDA events on the
    current stream around the call, so host waits inside it count too."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report(log, kernel, name=None):
    """{name: {"registers", "spill_stores", "spill_loads"}} of every entry
    function whose mangled name contains `kernel`, from a `-Xptxas -v` log;
    `name` maps a mangled name to its key (by default
    "kernel<template ints>")."""
    if name is None:
        def name(mangled):
            return f"{kernel}<{', '.join(re.findall(r'Li(\d+)E', mangled))}>"
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = name(m.group(1)) if kernel in m.group(1) else None
        elif key:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.setdefault(key, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def bag_name(mangled):
    """"bag_kernel<table, ids, VEC, rows>" of a mangled segment_bag
    instance."""
    k = re.search(r"bag_kernelI(f|13__nv_bfloat16)([il])Li(\d+)ELi(\d+)E",
                  mangled)
    return (f"bag_kernel<{'f32' if k.group(1) == 'f' else 'bf16'}, "
            f"{'i32' if k.group(2) == 'i' else 'i64'}, VEC {k.group(3)}, "
            f"rows {k.group(4)}>")


def profile(fn, label, top=6):
    """Device time of one call of fn by operation (torch.profiler): prints
    the window's wall time, the device's busy time and idle share, and the
    operations that took most device time; returns every device row as
    (name, ms, count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        # a later profiler session can drop its first device activity (the
        # one kernel of a window went unseen): a short spin kernel goes
        # first, outside the timed window and the rows
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies, memsets): an operator's row
    # repeats the device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    busy = sum(r[1] for r in rows)
    if not rows:
        print(f"  profile {label}: wall {wall:.3f} ms, device time not "
              "measured (the profiler saw no device activity)")
        return rows
    print(f"  profile {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    return rows


def device_ms(calls, reps=21):
    """{label: ms} of calls (label -> fn, each call launching one kernel):
    `reps` turns, each calling every fn once, in one torch.profiler window;
    the median of each kernel's own device time.  Every ms is None when the
    profiler saw another number of device activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)   # a first device activity can go unseen
        for _ in range(reps):
            for fn in calls.values():
                fn()
        torch.cuda.synchronize()
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin" not in e.name]
    if len(times) != reps * len(calls):
        return dict.fromkeys(calls)
    return {label: statistics.median(times[k::len(calls)])
            for k, label in enumerate(calls)}


def bag_bytes(table, ids):
    """(bound bytes, per-reference bytes, distinct rows, valid references)
    of one bag call.  Both byte counts hold the ids and the (B, D) output
    once; the bound adds every distinct row the ids name once, the
    per-reference figure (context, not a bound) every valid reference's
    row."""
    import torch
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = torch.unique(ids[valid]).numel()
    refs = int(valid.sum())
    row = table.shape[1] * table.element_size()
    stream = ids.numel() * ids.element_size() + ids.shape[0] * row
    return stream + rows * row, stream + refs * row, rows, refs


def ms_text(ms, places=3):
    """A device time for a print line: milliseconds to `places` places, or
    "not measured" where `device_ms` returned None."""
    return "not measured" if ms is None else f"{ms:.{places}f} ms"


def limit_share(got, want, tol):
    """The largest |got - want| / (atol + rtol |want|) (above 1 fails a
    closeness check) and the index of its element; tol: one number for rtol
    and atol, or an (rtol, atol) pair."""
    rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
    want = want.float()
    share = (got.float() - want).abs_().div_(want.abs().mul_(rtol)
                                             .add_(atol))
    at = int(share.argmax())
    return float(share.reshape(-1)[at]), [
        int(i) for i in np.unravel_index(at, tuple(share.shape))]


def standalone_kernels(order, conn, smi):
    """Phase 7: the four stand-alone kernels behind `repro_torch.kernels.ops`
    (`order` is the grid_512 order field of the main path).  Returns their
    entries of the kernels JSON line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import block_pathcompress as bpc_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import fused_local_phase as kmod
    from repro_torch.kernels import segment_bag as bag_mod
    from repro_torch.kernels import steepest_neighbor as steep_mod

    dev = order.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 matmuls
    err = {}

    def same(got, want, what):
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        check(got.dtype == want.dtype and got.shape == want.shape and e == 0,
              f"kernel == plain: {what} (max err {e})")
        return e

    def close(got, want, tol, what):
        """tol: one number for rtol and atol, or an (rtol, atol) pair."""
        torch.cuda.synchronize()
        rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
        e = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
        check(got.dtype == want.dtype and got.shape == want.shape and ok
              and not torch.isnan(got).any(),
              f"kernel == plain within rtol {rtol}, atol {atol}: {what} "
              f"(max abs err {e})")
        return e

    # 7a. kernel vs plain: ragged cases, then full size --------------------
    t0 = time.perf_counter()
    n_cases = 0
    n_rag = int(np.prod(RAGGED))
    rag_order = torch.randperm(n_rag, generator=gen, device=dev).to(
        torch.int32).reshape(RAGGED)
    rag_ties = torch.randint(0, 4, RAGGED, generator=gen, device=dev,
                             dtype=torch.int32)
    for c in (6, 14, 18, 26):
        for f in (rag_order, rag_ties):
            same(steep_mod.steepest_neighbor(f, c),
                 ref.steepest_neighbor_ref(f, c),
                 f"steepest_neighbor {RAGGED} conn {c}")
            n_cases += 1
    err["steepest_neighbor"] = same(
        steep_mod.steepest_neighbor(order, conn),
        ref.steepest_neighbor_ref(order, conn),
        f"steepest_neighbor grid_512 conn {conn}")
    ptr = ref.steepest_neighbor_ref(order, conn).reshape(-1)
    rag_ptr = ref.steepest_neighbor_ref(rag_order, 6).reshape(-1)
    for d, block, rounds in ((rag_ptr, 4096, 4), (rag_ptr, 1000, 3),
                             (rag_ptr, 65_536, 4), (ptr, 1 << 20, 2)):
        config = bpc_mod.configuration(
            ref.snapped_block(d.numel(), block), d.dtype)
        same(bpc_mod.block_pathcompress(d, rounds, block),
             ref.block_pathcompress_kernel_ref(d, rounds, block),
             f"block_pathcompress n {d.numel()} block {block} rounds "
             f"{rounds} ({config})")
        n_cases += 1
    err["block_pathcompress"] = same(
        bpc_mod.block_pathcompress(ptr, 4, 4096),
        ref.block_pathcompress_kernel_ref(ptr, 4, 4096),
        "block_pathcompress grid_512 pointers, rounds 4, block 4096")

    table = {"float32": torch.randn(BAG_V, BAG_D, generator=gen,
                                    device=dev)}
    table["bfloat16"] = table["float32"].to(torch.bfloat16)
    ids = torch.randint(-1, BAG_V, (BAG_B, BAG_L), generator=gen,
                        device=dev).to(torch.int32)
    over = torch.randint(0, ids.numel(), (64,), generator=gen, device=dev)
    ids.view(-1)[over] = BAG_V + torch.arange(64, device=dev,
                                              dtype=torch.int32)
    rag_ids = torch.randint(-3, 1005, (97, 61), generator=gen,
                            device=dev).to(torch.int32)
    for dt in ("float32", "bfloat16"):
        close(bag_mod.segment_bag(table[dt][:1000, :], rag_ids),
              ref.segment_bag_ref(table[dt][:1000, :], rag_ids),
              TOL[dt]["bag"], f"segment_bag V 1000, (97, 61) ids, {dt}")
        got, want = (bag_mod.segment_bag(table[dt], ids),
                     ref.segment_bag_ref(table[dt], ids))
        share, at = limit_share(got, want, TOL[dt]["bag"])
        print(f"  segment_bag serve_bulk {dt}: worst element at {share} of "
              f"its limit, (bag, column) {at}")
        err[f"segment_bag/{dt}"] = close(
            got, want, TOL[dt]["bag"],
            f"segment_bag V {BAG_V} D {BAG_D} ({BAG_B}, {BAG_L}) ids, {dt}")
        n_cases += 1
        del got, want

    def qkv(b, h, hkv, sq, sk, d, dt):
        shapes = ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
        return [torch.randn(s, generator=gen, device=dev).to(getattr(
            torch, dt)) for s in shapes]

    attn = {}
    attn_out = {}
    attn_plain = {}                    # f32: kept for SDPA's difference
    for dt in ("bfloat16", "float32"):
        for shape in ((1, 4, 2, 256, 128, 64), (1, 4, 2, 256, 256, 112)):
            q, k, v = qkv(*shape, dt)      # Sk < Sq: 128 rows see no key
            close(flash_mod.flash_attention(q, k, v, causal=True),
                  ref.flash_attention_kernel_ref(q, k, v, causal=True),
                  TOL[dt]["attn"], f"flash_attention {shape} causal {dt}")
            n_cases += 1
        # D = 320: the CUDA-core kernel in both dtypes, two column chunks
        q, k, v = qkv(1, 4, 2, 96, 64, 320, dt)
        key = f"{dt}_cuda_cores"
        before = flash_mod.launches[key]
        close(flash_mod.flash_attention(q, k, v, causal=True),
              ref.flash_attention_kernel_ref(q, k, v, causal=True),
              TOL[dt]["attn"], f"flash_attention (1, 4, 2, 96, 64, 320) "
              f"causal {dt}")
        check(flash_mod.launches[key] == before + 1,
              f"D = 320 {dt} ran the CUDA-core kernel ({key})")
        n_cases += 1
        attn[dt] = qkv(ATTN_B, ATTN_H, ATTN_HKV, ATTN_S, ATTN_S, ATTN_D, dt)
        attn_out[dt] = flash_mod.flash_attention(*attn[dt], causal=True)
        want = ref.flash_attention_kernel_ref(*attn[dt], causal=True)
        tol = ATTN_BF16_FULL if dt == "bfloat16" else TOL[dt]["attn"]
        share, at = limit_share(attn_out[dt], want, tol)
        print(f"  flash_attention 32k causal {dt}: worst element at {share} "
              f"of its limit, (b, h, query row, column) {at}")
        err[f"flash_attention/{dt}"] = close(
            attn_out[dt], want, tol,
            f"flash_attention llama3.2-1b 32k causal {dt}")
        if dt == "float32":
            attn_plain[dt] = want
        del want
    print(f"  {n_cases} ragged/small cases and 6 full-size cases: kernel == "
          f"plain (pointers exactly; bags within 1e-5 f32 / 3e-2 bf16; "
          f"attention within 2e-5 f32, bf16 2e-2 small and rtol "
          f"{ATTN_BF16_FULL[0]} / atol {ATTN_BF16_FULL[1]} at full size); "
          f"max errors {err}")
    phase("stand-alone kernels vs plain", t0)

    # 7b. the ops path, counts set to 0 just before and read just after ---
    t0 = time.perf_counter()
    mods = (kmod, steep_mod, bpc_mod, bag_mod, flash_mod)
    for mod in mods:
        for key in mod.launches:
            mod.launches[key] = 0
    got = {"steepest": ops.steepest_neighbor(order, conn)}
    got["bpc"] = ops.block_pathcompress(got["steepest"].reshape(-1), 4, 4096)
    for dt in ("float32", "bfloat16"):
        got[f"bag/{dt}"] = ops.embedding_bag(table[dt], ids)
    for dt in ("bfloat16", "float32"):
        got[f"attn/{dt}"] = ops.flash_attention(*attn[dt], causal=True)
    torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[1]: dict(mod.launches)
                for mod in mods}
    print(f"  kernel launches on the ops path: {launches}")
    check(launches["steepest_neighbor"][conn] == 1
          and launches["block_pathcompress"]["shared"] == 1
          and launches["segment_bag"] == {"float32": 1, "bfloat16": 1}
          and launches["flash_attention"]["float32"] == 1,
          "the ops path launched each stand-alone kernel once")
    check(launches["flash_attention"] == {"float32": 1,
                                          "float32_cuda_cores": 0,
                                          "bfloat16": 1,
                                          "bfloat16_cuda_cores": 0}
          and flash_mod.route(torch.bfloat16, ATTN_D) == "bfloat16"
          and flash_mod.route(torch.float32, ATTN_D) == "float32",
          "the ops path's attention ran each dtype's tensor-core kernel, "
          "once, and no other kernel")
    check(torch.equal(got["steepest"].reshape(-1), ptr)
          and torch.equal(got["bpc"], ref.block_pathcompress_kernel_ref(
              ptr, 4, 4096)), "ops pointers == the plain versions'")
    for dt in ("float32", "bfloat16"):
        check(torch.equal(got[f"bag/{dt}"], bag_mod.segment_bag(table[dt],
                                                                ids))
              and torch.equal(got[f"attn/{dt}"], attn_out[dt]),
              f"ops bags and attention ({dt}) == the compared kernel "
              "results (both kernels are deterministic)")
    n = order.numel()
    in_chain = int((got["bpc"] != ptr).sum())
    print(f"  grid_512 pointers: {n} ids, {in_chain} moved by 4 tile rounds")
    del got
    phase("ops path", t0)

    # 7c. numbers ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels = []

    def entry(name, src, line, launched, e, kernel, plain, nbytes, ops_,
              peak, library, one_kernel=False, **extra):
        """one_kernel: the call launches one kernel and nothing else, whose
        profiler device time goes beside the event time as `device_ms`."""
        k_ms, p_ms = event_ms(kernel, 5), event_ms(plain, 3)
        if one_kernel:
            extra["device_ms"] = device_ms({name: kernel})[name]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops_ / peak * 1e3
        lib_ms = None if library is None else event_ms(library, 5)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": launched, "max_abs_err": e, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": lib_ms, **extra})
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        on_device = ("" if "device_ms" not in extra else
                     f" (device {ms_text(extra['device_ms'])})")
        print(f"  {name}: kernel {k_ms:.3f} ms{on_device}, plain "
              f"{p_ms:.3f} ms, bound {max(by_bytes, by_ops):.3f} ms "
              f"({kernels[-1]['bound_by']}), library {lib} ({smi})")

    entry("steepest_neighbor", "steepest_neighbor", 90,
          launches["steepest_neighbor"][conn], err["steepest_neighbor"],
          lambda: ops.steepest_neighbor(order, conn),
          lambda: ref.steepest_neighbor_ref(order, conn),
          n * (4 + 4), n * conn, INT_OPS_PER_S, None, one_kernel=True)
    print("    library: none - no single PyTorch call computes a strict-> "
          "stencil argmax")
    # connectivity 26 on the same field, on a line of its own
    steep26 = lambda: ops.steepest_neighbor(order, 26)  # noqa: E731
    check(torch.equal(steep26(), ref.steepest_neighbor_ref(order, 26)),
          "steepest_neighbor grid_512 conn 26: kernel == plain")
    bound26 = max(n * 8 / HBM_BYTES_PER_S, n * 26 / INT_OPS_PER_S) * 1e3
    print(f"  steepest_neighbor conn 26 (grid_512, kernel == plain): kernel "
          f"{event_ms(steep26, 5):.3f} ms (device "
          f"{ms_text(device_ms({26: steep26})[26])}), "
          f"bound {bound26:.3f} ms ({smi})")
    global_ms = event_ms(lambda: ops.block_pathcompress(ptr, 4, 1 << 22), 5)
    entry("block_pathcompress", "block_pathcompress", 57,
          launches["block_pathcompress"]["shared"],
          err["block_pathcompress"],
          lambda: ops.block_pathcompress(ptr, 4, 4096),
          lambda: ref.block_pathcompress_kernel_ref(ptr, 4, 4096),
          n * (4 + 4), n * 4, INT_OPS_PER_S, None, one_kernel=True,
          global_config_block_4M_ms=global_ms)
    print(f"    library: none - no single PyTorch call runs tile-confined "
          f"doubling; the global configuration (block 2^22) takes "
          f"{global_ms:.3f} ms")
    # the library call: in-range ids only (F.embedding_bag refuses ids >= V)
    lib_ids = torch.where(ids < BAG_V, ids, -1).long()
    lib_w = {dt: (lib_ids >= 0).to(table[dt].dtype) for dt in table}
    for dt in ("float32", "bfloat16"):
        nbytes, per_ref, rows, refs = bag_bytes(table[dt], ids)
        entry(f"segment_bag/{dt}", "segment_bag", 62,
              launches["segment_bag"][dt], err[f"segment_bag/{dt}"],
              lambda: ops.embedding_bag(table[dt], ids),
              lambda: ref.segment_bag_ref(table[dt], ids),
              nbytes, refs * BAG_D, INT_OPS_PER_S,
              lambda: F.embedding_bag(lib_ids.clamp(min=0), table[dt],
                                      per_sample_weights=lib_w[dt],
                                      mode="sum"),
              one_kernel=True, distinct_rows=rows)
        print(f"    per-reference figure (context, not the bound: every "
              f"valid reference's row + ids + output over 3.35 TB/s) "
              f"{per_ref / HBM_BYTES_PER_S * 1e3:.3f} ms")
    # BST's own calls (models/bst.py): one a multihot field, field f's ids
    # in [f * 500,000, (f + 1) * 500,000) with -1 pads drawn as
    # data/recsys.py draws them (uniform over [-1, 500,000)), the two fields
    # in turns as a forward pass calls them
    for shape, b in (("serve_bulk", BAG_B), ("serve_p99", BST_P99)):
        fids = []
        for f in range(BST_FIELDS):
            x = torch.randint(-1, BST_FIELD_V, (b, BAG_L), generator=gen,
                              device=dev, dtype=torch.int32)
            fids.append(torch.where(x >= 0, x + f * BST_FIELD_V, -1))
        for dt in ("float32", "bfloat16"):
            calls = {f: (lambda i=i: ops.embedding_bag(table[dt], i))
                     for f, i in enumerate(fids)}
            errs = {f: close(calls[f](), ref.segment_bag_ref(table[dt], i),
                             TOL[dt]["bag"], f"segment_bag BST field {f} "
                             f"{shape} {dt}") for f, i in enumerate(fids)}
            for f, on_device in device_ms(calls).items():
                nbytes, per_ref, rows, _ = bag_bytes(table[dt], fids[f])
                print(f"  segment_bag BST field {f} {shape} ({b}, {BAG_L}) "
                      f"{dt} (kernel == plain, max abs err {errs[f]}): "
                      f"kernel {event_ms(calls[f], 5):.4f} ms (device "
                      f"{ms_text(on_device, 4)}, fields in turns), bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes; "
                      f"{rows} distinct rows), per-reference figure "
                      f"{per_ref / HBM_BYTES_PER_S * 1e3:.4f} ms (context, "
                      f"not a bound) ({smi})")
    reports = ptxas_report(_build.build_log("segment_bag"), "bag_kernel",
                           bag_name)
    for name, rep in reports.items():
        print(f"  ptxas {name}: {rep}")
    shipped = {k: r for k, r in reports.items() if "VEC 16" in k}
    check(len(shipped) == 4 and all(
        r.get("spill_stores") == 0 and r.get("spill_loads") == 0
        for r in shipped.values()), f"the four 16-byte bag instances (f32 /"
          f" bf16 x i32 / i64, D = 32's) build without spills: {shipped}")
    from torch.nn.attention import SDPBackend, sdpa_kernel
    pairs = ATTN_S * (ATTN_S + 1) // 2           # visible (q, k) pairs
    flops = 4 * ATTN_B * ATTN_H * ATTN_D * pairs
    log = _build.build_log("flash_attention")
    ptxas = {"bfloat16": ptxas_report(log, "flash_tc"),
             "float32": ptxas_report(log, "flash_f32tc")}
    check(len(ptxas["bfloat16"]) == 3 and len(ptxas["float32"]) == 2,
          f"ptxas reports the tensor-core instances (bf16 Dp 64, 128, 256; "
          f"f32 Dp 64, 128): {ptxas}")
    for reports in ptxas.values():
        for name, rep in reports.items():
            print(f"  ptxas {name}: {rep}")
    designs = {"bfloat16": "tensor cores: mma.sync m16n8k16 bf16 -> fp32, "
               "ldmatrix, cp.async x2 (two-stage K/V ring), P as bf16 hi + "
               "lo (two PV mma); D = 64: 128 query rows x 64 keys a CTA of "
               "4 warps",
               "float32": "QK^T on the CUDA cores (one fma chain over D per "
               "score, the reference's order; float4 shared loads), P V on "
               "the tensor cores in 3xTF32 (mma.sync m16n8k8, P and V split "
               "into TF32 big + small in registers, 12 mma a part that O "
               "takes in by an fp32 add), cp.async x2 (two-stage K/V ring); "
               "D = 64: 128 query rows x 64 keys a CTA of 4 warps"}

    def sdpa_call(dt, q, k, v):
        """One SDPA call for the same function at Sq == Sk (its causal mask
        is top-left aligned), never the math backend, which would hold the
        32k x 32k scores (137 GB).  Returns (call, how GQA is given)."""
        if dt == "bfloat16":
            def call():
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
            return call, "enable_gqa"
        # the memory-efficient backend refuses enable_gqa: K and V expanded
        # to H heads here, outside the timed call
        k_h, v_h = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
                    for t in (k, v))

        def call():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(q, k_h, v_h,
                                                      is_causal=True)
        return call, "K and V repeat_interleave'd to H"

    for dt in ("bfloat16", "float32"):
        q, k, v = attn[dt]
        size = q.element_size()
        lib, gqa = sdpa_call(dt, q, k, v)
        extra = {"design": designs[dt], "ptxas": ptxas[dt],
                 "library_gqa": gqa}
        entry(f"flash_attention/{dt}", "flash_attention", 87,
              launches["flash_attention"][dt], err[f"flash_attention/{dt}"],
              lambda: ops.flash_attention(q, k, v, causal=True),
              lambda: ref.flash_attention_kernel_ref(q, k, v, causal=True),
              (2 * q.numel() + 2 * k.numel()) * size,
              flops, FLOPS_PER_S[dt], lib, **extra)
        row = kernels[-1]
        row["tflops"] = flops / row["ms"] / 1e9
        print(f"    {row['tflops']:.1f} TFLOP/s fp32-equivalent ({flops:.4e} "
              f"flops; the bound's {FLOPS_PER_S[dt] / 1e12:.1f} TFLOP/s in "
              f"{row['bound_ms']:.3f} ms; SDPA "
              f"{flops / row['library_ms'] / 1e9:.1f} TFLOP/s, GQA by "
              f"{gqa}; {row['design']})")
        if dt == "float32":
            cuda_cores = flops / FLOPS_PER_S["float32_cuda_cores"] * 1e3
            print(f"    bound: 3xTF32 at 494.7 TFLOP/s {row['bound_ms']:.3f} "
                  f"ms; derived, not measured: the fp32 CUDA-core figure "
                  f"(67 TFLOP/s, the earlier bound) {cuda_cores:.3f} ms, this "
                  f"design's floor (QK^T on the CUDA cores) "
                  f"{cuda_cores / 2:.3f} ms; the previous design took "
                  f"{EARLIER_FLASH_F32_MS} ms in an earlier run (PERF.md, "
                  f"run T), not measured here")
        want, what = ((attn_plain.pop(dt), "plain") if dt in attn_plain
                      else (attn_out[dt], "kernel"))
        e = float((lib().float() - want.float()).abs().max())
        print(f"    SDPA vs {what}: max abs difference {e} (not a check: "
              "SDPA tiles and rounds in its own way)")

    def pointer_and_bag_calls():
        d = ops.steepest_neighbor(order, conn)
        ops.block_pathcompress(d.reshape(-1), 4, 4096)
        for dt in ("float32", "bfloat16"):
            ops.embedding_bag(table[dt], ids)

    profile(pointer_and_bag_calls, "ops path: steepest_neighbor + "
            "block_pathcompress + embedding_bag f32 and bf16")
    for dt in ("bfloat16", "float32"):
        profile(lambda: ops.flash_attention(*attn[dt], causal=True),
                f"ops path: flash_attention {dt}")
    phase("stand-alone numbers", t0)
    return kernels


def graph_path(smi, dev):
    """Phase 8: the graph domain on the card (`configs/dpc_graph.py`), through
    `repro_torch.topology.submit(domain="graph")`: the tet mesh of a 256^3
    grid (an `ms` query on the order field, a `cc` query on the top-10% mask,
    a pure-geometry `cc` with mask = ones) and `random_1m` (`cc` with mask =
    ones and with a top-10% mask).  The graph path launches no kernel (JAX
    computes it outside Pallas): every launch count is read as 0 after it.
    Checks that trust no single path: graph `ms` and `cc` == the grid path at
    connectivity 14 (whose ms launches the fused kernel twice, cc once),
    geometry labels all n - 1, `random_1m` == scipy's connected components
    relabelled to the largest vertex id.  Returns the phase's numbers and,
    on the host, phase 10's inputs and the pure labels it is held to."""
    import torch
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    from repro_torch.configs.dpc_graph import SHAPES as GRAPH_SHAPES, \
        full_config as graph_config
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.ids import compute_order
    from repro_torch.core.ms_segmentation import ms_segmentation
    from repro_torch.core.steepest import neighbor_offsets
    from repro_torch.data import grid_edge_list, perlin_noise, quantile, \
        random_csr
    from repro_torch.interop import canonical_tensor
    from repro_torch.kernels import block_pathcompress, flash_attention, \
        fused_local_phase, segment_bag, steepest_neighbor
    from repro_torch.topology import TopologyRequest, submit

    mods = (fused_local_phase, steepest_neighbor, block_pathcompress,
            segment_bag, flash_attention)

    def zero_launches():
        for mod in mods:
            for key in mod.launches:
                mod.launches[key] = 0

    def read_launches():
        torch.cuda.synchronize()
        return {mod.__name__.rsplit(".", 1)[1]: dict(mod.launches)
                for mod in mods}

    def gb(nbytes):
        return nbytes / 1e9

    cfg = graph_config()
    conn, q = cfg.connectivity, cfg.threshold_quantile
    numbers = {}
    t0 = time.perf_counter()
    print(f"  device memory allocated at the phase's start: "
          f"{gb(torch.cuda.memory_allocated()):.3f} GB")

    # 8a. inputs ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    s64, r64 = grid_edge_list(TET_DIMS, conn, device=dev)
    want_edges = sum(int(np.prod([d - abs(o) for d, o in zip(TET_DIMS, off)]))
                     for off in neighbor_offsets(3, conn))
    check(s64.numel() == r64.numel() == want_edges and s64.dtype ==
          torch.int64, f"tet mesh {TET_DIMS}: {want_edges} int64 edges")
    senders, receivers = (canonical_tensor(e, dev) for e in (s64, r64))
    del s64, r64
    numbers["tet_edges"] = senders.numel()
    numbers["tet_edge_list_peak_GB"] = gb(torch.cuda.max_memory_allocated())
    field = perlin_noise(TET_DIMS, frequency=0.1, seed=SEED, device=dev)
    order = compute_order(field)
    mask = field > quantile(field, q)
    del field
    n = order.numel()
    flat = {"order": order.reshape(-1), "mask": mask.reshape(-1),
            "ones": torch.ones(n, dtype=torch.bool, device=dev)}
    edges = dict(domain="graph", senders=senders, receivers=receivers)
    spec = GRAPH_SHAPES["random_1m"]
    n_rand = spec["n"]
    indptr, recv = random_csr(n_rand, spec["avg_degree"], seed=0)
    send = np.repeat(np.arange(n_rand, dtype=np.int64), np.diff(indptr))
    rand_edges = dict(domain="graph", senders=canonical_tensor(send, dev),
                      receivers=canonical_tensor(recv, dev))
    rand_field = torch.from_numpy(np.random.default_rng(SEED).random(
        n_rand, dtype=np.float32)).to(dev)
    rand_masks = {"ones": torch.ones(n_rand, dtype=torch.bool, device=dev),
                  "top10": rand_field > quantile(rand_field, q)}
    numbers["random_1m_edges"] = int(send.size)
    print(f"  tet mesh {TET_DIMS} (connectivity {conn}): {n} vertices, "
          f"{numbers['tet_edges']} directed edges, int32 "
          f"{gb(2 * senders.numel() * 4):.3f} GB; random_1m: {n_rand} "
          f"vertices, {numbers['random_1m_edges']} directed edges")
    phase("graph inputs", t0)

    # 8b. the graph path, counts set to 0 just before and read just after --
    t0 = time.perf_counter()
    requests = {
        "tet ms": TopologyRequest("ms", order=flat["order"], **edges),
        "tet cc": TopologyRequest("cc", mask=flat["mask"], **edges),
        "tet geometry cc": TopologyRequest("cc", mask=flat["ones"], **edges),
        "random_1m cc": TopologyRequest("cc", mask=rand_masks["ones"],
                                        **rand_edges),
        "random_1m top-10% cc": TopologyRequest(
            "cc", mask=rand_masks["top10"], **rand_edges)}
    zero_launches()
    res, peak = {}, {}
    for name, req in requests.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res[name] = submit(req, dev)
        torch.cuda.synchronize()
        peak[name] = gb(torch.cuda.max_memory_allocated())
    launches = read_launches()
    print(f"  kernel launches on the graph path: {launches}")
    check(all(v == 0 for d in launches.values() for v in d.values()),
          "the graph path launches no kernel (JAX computes it outside "
          "Pallas)")
    for name, r in res.items():
        for k in ("labels", "ascending", "descending", "segmentation"):
            t = getattr(r, k)
            if t is not None:
                check(t.dtype == torch.int32 and t.device.type == dev.type
                      and t.dim() == 1, f"{name} {k} is a 1-D int32 tensor "
                      f"on {dev.type}")
        numbers[f"{name} meta"] = r.meta
        numbers[f"{name} peak_GB"] = peak[name]
        print(f"  {name}: meta {r.meta}, peak device memory "
              f"{peak[name]:.3f} GB ({smi})")
    phase("graph path", t0)

    # 8c. checks that trust no single path ----------------------------------
    t0 = time.perf_counter()
    zero_launches()
    grid_ms = ms_segmentation(order, conn)
    grid_cc = connected_components_grid(mask, conn)
    grid_launches = read_launches()["fused_local_phase"]
    print(f"  kernel launches of the grid cross-check: {grid_launches}")
    check(grid_launches == {"manifold": 2, "cc": 1},
          "the grid cross-check launched the fused kernel (ms 2, cc 1)")
    g = res["tet ms"]
    for k in ("ascending", "descending", "segmentation"):
        check(torch.equal(getattr(g, k), getattr(grid_ms, k).reshape(-1)),
              f"graph ms {k} == grid ms_segmentation at connectivity {conn}")
    check(torch.equal(res["tet cc"].labels, grid_cc.labels.reshape(-1)),
          f"graph cc labels == grid cc at connectivity {conn}")
    check(bool((res["tet geometry cc"].labels == n - 1).all()),
          "pure-geometry labels are all n - 1 (the tet mesh is connected)")
    pair = g.descending.long() * n + g.ascending.long()
    numbers["tet_segments"] = torch.unique(pair).numel()
    numbers["tet_segments_by_int32_hash"] = torch.unique(
        g.segmentation).numel()
    numbers["tet_cc_components"] = torch.unique(
        res["tet cc"].labels).numel() - 1
    del grid_ms, grid_cc, pair
    s_np, r_np = send, recv.astype(np.int64)
    for key, label in (("ones", "random_1m cc"),
                       ("top10", "random_1m top-10% cc")):
        m = rand_masks[key].cpu().numpy()
        keep = m[s_np] & m[r_np]
        adj = sp.coo_matrix((np.ones(int(keep.sum()), np.int8),
                             (s_np[keep], r_np[keep])),
                            shape=(n_rand, n_rand)).tocsr()
        n_comp, lab = connected_components(adj, directed=False)
        top = np.full(n_comp, -1, np.int64)
        np.maximum.at(top, lab, np.arange(n_rand))
        want = np.where(m, top[lab], -1).astype(np.int32)
        got = res[label].labels.cpu().numpy()
        n_bad = int((got != want).sum())
        numbers[f"{label} components"] = int(np.unique(want[m]).size)
        check(n_bad == 0, f"{label} == scipy connected_components "
              f"relabelled to the largest vertex id ({n_bad} differ)")
    print(f"  graph ms == grid ms and graph cc == grid cc at connectivity "
          f"{conn} ({TET_DIMS}); geometry labels all n - 1; random_1m == "
          f"scipy (ones and top-10% masks)")
    phase("graph checks", t0)

    # 8d. numbers: warm query times, profiles --------------------------------
    t0 = time.perf_counter()
    for name, req in requests.items():
        numbers[f"{name} query_ms"] = event_ms(lambda: submit(req, dev), 3)
        print(f"  {name}: warm query {numbers[f'{name} query_ms']:.3f} ms "
              f"(median of 3, CUDA events) ({smi})")
    for name in ("tet ms", "tet cc"):
        profile(lambda: submit(requests[name], dev), f"graph {name} query",
                top=8)
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    phase("graph numbers", t0)
    # phase 10's inputs and references, on the host
    dist_in = {"tet_send": senders.cpu().numpy(),
               "tet_recv": receivers.cpu().numpy(),
               "tet_mask": flat["mask"].cpu().numpy(),
               "tet_pure": {"top10": res["tet cc"].labels.cpu().numpy(),
                            "ones": res["tet geometry cc"].labels.cpu(
                                ).numpy()},
               "rand_send": send, "rand_recv": recv,
               "rand_field": rand_field.cpu().numpy(),
               "rand_pure": {"ones": res["random_1m cc"].labels.cpu(
                   ).numpy(), "top10": res["random_1m top-10% cc"].labels.cpu(
                   ).numpy()}}
    return numbers, dist_in


def _src_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def _fused_launches():
    from repro_torch.kernels import fused_local_phase as kmod
    return dict(kmod.launches)


def _zero_fused_launches():
    from repro_torch.kernels import fused_local_phase as kmod
    for mode in kmod.launches:
        kmod.launches[mode] = 0


def _dist_query(query, block, mesh, shape, conn, mode):
    """One call of the port's distributed backend: "desc" / "asc" manifold
    of block[0], cc of block[1] with the mask gathered ("cc") or not
    ("cc_nogather")."""
    from repro_torch.core.distributed import (
        distributed_connected_components, distributed_manifold)
    if query in ("desc", "asc"):
        return distributed_manifold(block[0], mesh, shape, conn,
                                    descending=query == "desc",
                                    table_mode=mode)
    return distributed_connected_components(
        block[1], mesh, shape, conn, gather_mask=query == "cc",
        table_mode=mode)


def _closed_forms(dec, conn, query, mode, stats, masked):
    """The DPCStats fields that have a closed form in the decomposition
    (`masked`: masked in-domain table slots, for cc)."""
    from repro_torch.core.distributed import _ShardGeom
    f32, isz = np.float32, 4
    gm, cc = query == "cc", query.startswith("cc")
    rounds = int(stats.exchange_rounds)
    want = {"pad_fraction": f32(dec.pad_fraction), "converged": 1,
            "masked_ghost_fraction": (f32(masked) / f32(max(
                dec.n_valid_slots, 1)) if cc else f32(1.0))}
    if mode == "replicated":
        want.update(comm_phases=1, exchange_rounds=0,
                    ghost_bytes=f32(dec.n_valid_slots * isz)
                    + (f32(dec.n_valid_slots) if gm else f32(0.0)),
                    table_bytes_peak=f32(dec.table_size * (isz + cc)))
    else:
        geom = _ShardGeom(dec, None, conn)
        halo = geom.stack_size - geom.rows
        if cc:
            want.update(comm_phases=rounds + 1, ghost_bytes=f32(halo * isz)
                        * (f32(rounds) + f32(1)) + (f32(halo) if gm
                                                    else f32(0.0)),
                        table_bytes_peak=f32((2 * geom.stack_size + geom.rows)
                                             * isz + geom.stack_size))
        else:
            want.update(comm_phases=rounds,
                        ghost_bytes=f32(halo * isz) * f32(rounds),
                        table_bytes_peak=f32((geom.stack_size + geom.rows)
                                             * isz))
    for field, w in want.items():
        got = getattr(stats, field).item()
        check((np.float32(got) == w) if isinstance(w, np.float32)
              else got == w, f"{query} {mode} conn {conn}: {field} {got} == "
              f"its closed form {w}")


def _ghost_masked_vs_plain(block, dec, mesh, conn, what):
    """The distributed path's fused launch, with the ghost `self_mask` on
    this rank's extended block (`local + 2` on each decomposed axis), held
    to the plain version on the same inputs: pointers and rounds exactly
    equal.  `block` is (order, mask) as the rank owns them.  Returns {mode:
    (max abs error, rounds)}.  Collective (the halo shifts): every rank
    calls it in the same order, outside any window where launches count."""
    from repro_torch.core.distributed import _extend, _pad_block
    from repro_torch.kernels import fused_local_phase as kmod, ref
    ghost = dec.on_device("ghost", mesh.device)
    out = {}
    for kind, fill, field in (("manifold", -1, block[0]),
                              ("cc", False, block[1])):
        ext = _extend(_pad_block(field[None], dec, mesh, fill), dec, mesh,
                      fill)[0]
        got, r = kmod.fused_local_phase(ext, conn, mode=kind,
                                        self_mask=ghost)
        want, wr = ref.fused_local_phase_ref(ext, conn, mode=kind,
                                             self_mask=ghost)
        e = int((got.long() - want.long()).abs().max())
        check(got.dtype == want.dtype and e == 0 and r == wr,
              f"{what} conn {conn} {kind}: ghost-masked kernel on the "
              f"extended block {tuple(ext.shape)} == plain (max err {e}, "
              f"rounds {r} vs {wr})")
        out[kind] = (e, r)
        del ext, got, want
    return out


def _counted(mesh):
    """Wrap a mesh's collectives with call counters; returns the dict."""
    counts = {"shift": 0, "permute": 0, "all_gather": 0, "all_reduce": 0}
    for name in counts:
        def wrapped(*args, _f=getattr(mesh, name), _name=name, **kw):
            counts[_name] += 1
            return _f(*args, **kw)
        setattr(mesh, name, wrapped)
    return counts


def _facade_9a(smi, host, block, mesh, shape, conn, direct, dev):
    """9a's facade sub-phase on the one-rank mesh: `submit(backend=
    "distributed")` for cc, both manifolds, ms and a threshold sweep over
    the field's `SWEEP_QS` quantiles, in both table modes, each == the
    direct calls (labels and stats, `direct`) and the pure routes (phase 4's
    labels and segmentation; the pure sweep).  The sweep's batched call
    launches the fused kernel once a mask, on the card held to the plain
    version (pointers and rounds, and the rounds its stats report); then
    the batched sweep's warm time beside four single distributed calls,
    and its peak memory.  Returns (launches, fused errors)."""
    import torch
    from repro_torch.core.distributed import (
        _decomp_for, _extend, _pad_block, distributed_connected_components)
    from repro_torch.data import perlin_noise, quantile
    from repro_torch.kernels import fused_local_phase as kmod, ref
    from repro_torch.topology import TopologyRequest, submit
    on_card = dev.type == "cuda"
    field = perlin_noise(shape, frequency=0.1, seed=SEED, device=dev)
    thr = np.array([quantile(field, qq) for qq in SWEEP_QS], np.float32)
    pure_sweep = submit(TopologyRequest("threshold_sweep", field=field,
                                        thresholds=thr, connectivity=conn),
                        dev).labels
    base = dict(backend="distributed", mesh=mesh, grid_shape=shape,
                connectivity=conn)
    rounds = {}
    _zero_fused_launches()
    for mode in MODES:
        req = dict(base, table_mode=mode)
        res = submit(TopologyRequest("cc", mask=block[1], **req))
        check(torch.equal(res.labels.cpu(), host["labels"])
              and res.stats == direct["cc", mode],
              f"9a facade cc {mode} == the direct call and the pure route")
        for desc, want, key in ((True, "descending", "desc"),
                                (False, "ascending", "asc")):
            res = submit(TopologyRequest("manifold", order=block[0],
                                         descending=desc, **req))
            check(torch.equal(res.labels.cpu(), host[want])
                  and res.stats == direct[key, mode],
                  f"9a facade manifold {want} {mode} == the direct call and "
                  f"the pure route")
        res = submit(TopologyRequest("ms", order=block[0], **req))
        check(all(torch.equal(getattr(res, k).cpu(), host[k]) for k in (
            "descending", "ascending", "segmentation"))
              and res.stats == {"descending": direct["desc", mode],
                                "ascending": direct["asc", mode]},
              f"9a facade ms {mode}: both manifolds and the segmentation "
              f"(pair hash with n = {int(np.prod(shape))}) == the pure ms "
              f"query's, stats == the direct calls'")
        res = submit(TopologyRequest("threshold_sweep", field=field,
                                     thresholds=thr, **req))
        check(torch.equal(res.labels, pure_sweep)
              and res.stats["converged"] == [1] * len(SWEEP_QS),
              f"9a facade threshold_sweep {mode} (K = {len(SWEEP_QS)}, one "
              f"batched call) == the pure sweep")
        rounds[mode] = res.stats["kernel_rounds"]
        print(f"  9a facade {mode}: cc, manifolds, ms, sweep == direct and "
              f"pure; sweep stats {res.stats}")
        del res
    launches = _fused_launches()
    per_mode = {"manifold": 4, "cc": 1 + len(SWEEP_QS)}
    check(not on_card or launches == {k: 2 * v for k, v in per_mode.items()},
          f"9a facade: the fused kernel launched once a call and once a "
          f"sweep mask ({launches})")
    del pure_sweep
    fused = {}
    if on_card:
        dec = _decomp_for(mesh, shape)
        ghost = dec.on_device("ghost", dev)
        masks = field[None] > torch.from_numpy(thr).to(dev).reshape(
            -1, 1, 1, 1)
        ext = _extend(_pad_block(masks, dec, mesh, False), dec, mesh, False)
        err = 0
        for k, x in enumerate(ext):
            got, r = kmod.fused_local_phase(x, conn, mode="cc",
                                            self_mask=ghost)
            want, wr = ref.fused_local_phase_ref(x, conn, mode="cc",
                                                 self_mask=ghost)
            e = int((got.long() - want.long()).abs().max())
            err = max(err, e)
            check(e == 0 and r == wr and all(rounds[m][k] == r
                                              for m in MODES),
                  f"9a sweep mask {k}: the batch's ghost-masked launch on "
                  f"the {tuple(x.shape)} extended block == plain (max err "
                  f"{e}, rounds {r} vs {wr}; stats {rounds})")
            del got, want
        fused["cc"] = (err, max(max(v) for v in rounds.values()))
        del ext
        print(f"  9a facade sweep: {len(SWEEP_QS)} ghost-masked fused "
              f"launches of the batch == plain (pointers and rounds; max "
              f"err, rounds): {fused['cc']}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        submit(TopologyRequest("threshold_sweep", field=field,
                               thresholds=thr, **base))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        sweep_ms = event_ms(lambda: submit(TopologyRequest(
            "threshold_sweep", field=field, thresholds=thr, **base)), 3)
        single_ms = event_ms(lambda: [distributed_connected_components(
            m, mesh, shape, conn) for m in masks], 3)
        print(f"  9a distributed threshold_sweep, K = {len(SWEEP_QS)}, one "
              f"batched call: {sweep_ms:.3f} ms; four single distributed "
              f"cc calls: {single_ms:.3f} ms (warm, median of 3, CUDA "
              f"events, replicated); sweep peak device memory {peak:.3f} GB "
              f"({smi})")
        del masks
    del field, thr
    return launches, fused


def _rank_setup(rank, world, store, backend, device):
    """A rank of phase 9: the port on the path, the card, the group."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, _src_path())
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)


def _rank_9b(rank, store, tmp, shape, conn, device):
    """Phase 9b, one of two ranks sharing the card over gloo: ms (both
    manifolds) and cc of its 512^3 block in both table modes; checks the
    modes agree; a batched cc of two masks against its single calls and
    their collectives; writes the replicated labels, stats, launch and
    collective counts and warm times (median of 3, CUDA events) to
    `tmp`."""
    import torch
    import torch.distributed as dist
    _rank_setup(rank, 2, store, "gloo", device)
    from repro_torch.core.distributed import (
        _decomp_for, distributed_connected_components,
        distributed_connected_components_batch, make_dpc_mesh)
    mesh = make_dpc_mesh((2,), device=device)
    block = tuple(torch.from_numpy(np.load(os.path.join(
        tmp, f"{what}{rank}.npy"))).to(device) for what in ("order", "mask"))
    out = {"stats": {}, "ms": {}, "fused": {}}
    on_card = device == "cuda"
    _zero_fused_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for query in ("desc", "asc", "cc"):
        got = {}
        for mode in ("replicated", "sharded"):
            got[mode], stats = _dist_query(query, block, mesh, shape, conn,
                                           mode)
            out["stats"][f"{query} {mode}"] = stats.as_dict()
        check(torch.equal(got["replicated"], got["sharded"]),
              f"9b rank {rank} {query}: replicated == sharded labels")
        np.save(os.path.join(tmp, f"got_{query}{rank}.npy"),
                got["replicated"].cpu().numpy())
        del got
    out["launches"] = _fused_launches()
    # a batched cc of B = 2 masks (the top-10% block and the top-20% one):
    # each item == its single call, and the batch issues as many shifts,
    # all-gathers and all-reduces as one single call (replicated)
    cmesh = make_dpc_mesh((2,), device=device)
    counts = _counted(cmesh)
    mask2 = torch.from_numpy(np.load(os.path.join(
        tmp, f"mask2_{rank}.npy"))).to(device)
    _zero_fused_launches()
    got, stats = distributed_connected_components_batch(
        torch.stack([block[1], mask2]), cmesh, shape, conn)
    out["batch_launches"] = _fused_launches()
    out["batch_counts"] = dict(counts)
    for k in counts:
        counts[k] = 0
    want2, stats2 = distributed_connected_components(mask2, cmesh, shape,
                                                     conn)
    out["single_counts"] = dict(counts)
    want1 = torch.from_numpy(np.load(os.path.join(tmp, f"got_cc{rank}.npy")))
    check(torch.equal(got[0].cpu(), want1) and torch.equal(got[1], want2),
          f"9b rank {rank}: the batch's items == their single calls")
    check(all(getattr(stats, f)[1].item() == v.item()
              for f, v in zip(stats2._fields, stats2))
          and stats.as_dict()["converged"] == [1, 1]
          and out["batch_counts"] == out["single_counts"],
          f"9b rank {rank}: batch stats == the single calls', collectives "
          f"{out['batch_counts']} == one single call's "
          f"{out['single_counts']}")
    out["batch_stats"] = stats.as_dict()
    del got, want1, want2, mask2
    if on_card:
        torch.cuda.synchronize()
        out["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        out["fused"] = _ghost_masked_vs_plain(
            block, _decomp_for(mesh, shape), mesh, conn, f"9b rank {rank}")
        for mode in ("replicated", "sharded"):
            for query, calls in (("ms", ("desc", "asc")), ("cc", ("cc",))):
                out["ms"][f"{query} {mode}"] = event_ms(lambda: [_dist_query(
                    q, block, mesh, shape, conn, mode) for q in calls], 3)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _rank_9c(rank, store, tmp, cases, device):
    """Phase 9c, one of eight ranks sharing the card over gloo, layout
    (2, 2, 2): each case's block through ms and cc in both table modes,
    the mask gathered and not, held to the pure path on the card (each
    rank runs it on the global input) and the stats to their closed forms;
    and this rank's ghost-masked fused launch on its extended block held to
    the plain version.  Writes launch counts to `tmp`."""
    import torch
    import torch.distributed as dist
    _rank_setup(rank, 8, store, "gloo", device)
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.distributed import _decomp_for, make_dpc_mesh
    from repro_torch.core.ms_segmentation import (ascending_manifold,
                                                  descending_manifold)
    mesh = make_dpc_mesh((2, 2, 2), device=device)
    launches, n_fused = {"manifold": 0, "cc": 0}, 0
    err = {"manifold": 0, "cc": 0}
    for shape, mask_p, seed in cases:
        rng = np.random.default_rng(seed)
        order = torch.from_numpy(rng.permutation(int(np.prod(shape))).reshape(
            shape).astype(np.int32)).to(device)
        mask = torch.from_numpy(rng.random(shape) < mask_p).to(device)
        dec = _decomp_for(mesh, shape)
        sl = dec.block_slices(mesh.coords)
        block = (order[sl], mask[sl])
        coords = dec.boundary_coords
        real = (coords < np.asarray(dec.grid)).all(axis=1)
        masked = int(mask.cpu().numpy()[tuple(coords[real].T)].sum())
        for conn in (6, 26):
            pure = {"desc": descending_manifold(order, conn)[0],
                    "asc": ascending_manifold(order, conn)[0],
                    "cc": connected_components_grid(mask, conn).labels}
            pure["cc_nogather"] = pure["cc"]
            kernel_rounds = {}
            for mode in ("replicated", "sharded"):
                for query in ("desc", "asc", "cc", "cc_nogather"):
                    _zero_fused_launches()
                    got, stats = _dist_query(query, block, mesh, shape, conn,
                                             mode)
                    for k, v in _fused_launches().items():
                        launches[k] += v
                    check(torch.equal(got, pure[query].reshape(shape)[sl]),
                          f"9c rank {rank} {shape} conn {conn} {mode} "
                          f"{query}: labels == the pure path's")
                    _closed_forms(dec, conn, query, mode, stats, masked)
                    kernel_rounds[mode, query] = int(stats.kernel_rounds)
            if device != "cuda":
                continue
            fused = _ghost_masked_vs_plain(block, dec, mesh, conn,
                                           f"9c rank {rank} {shape}")
            for kind, (e, _) in fused.items():
                err[kind] = max(err[kind], e)
            n_fused += len(fused)
            # the stats' kernel_rounds is the largest rank's
            top = torch.tensor([fused["manifold"][1], fused["cc"][1]])
            dist.all_reduce(top, op=dist.ReduceOp.MAX)
            for mode in ("replicated", "sharded"):
                check(kernel_rounds[mode, "desc"] == int(top[0])
                      and kernel_rounds[mode, "cc"] == int(top[1]),
                      f"9c {shape} conn {conn} {mode}: stats kernel_rounds "
                      f"(desc {kernel_rounds[mode, 'desc']}, cc "
                      f"{kernel_rounds[mode, 'cc']}) == the ranks' largest "
                      f"({top.tolist()})")
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "fused_compared": n_fused,
                   "fused_err": err}, f)
    dist.destroy_process_group()


def _peak_host_gb():
    """This process's peak resident host memory (ru_maxrss, kB on Linux)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _rank_10a(rank, store, tmp, n, device):
    """Phase 10a, one of `GRAPH_PARTS` ranks sharing the card over gloo: the
    tet mesh's GraphDecomp (numpy, timed), then cc of the top-10% mask and
    of mask = ones in both table modes, the mask gathered and not; the
    four variants' labels agree, and this rank's labels equal the pure
    graph cc's at its owned vertices.  Writes the replicated gathered
    labels, stats, times and memory to `tmp`."""
    import torch
    import torch.distributed as dist
    _rank_setup(rank, GRAPH_PARTS, store, "gloo", device)
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.core.distributed_graph import (
        GraphDecomp, distributed_connected_components_graph)
    on_card = device == "cuda"
    t = time.perf_counter()
    dec = GraphDecomp(n, np.load(os.path.join(tmp, "tet_send.npy")),
                      np.load(os.path.join(tmp, "tet_recv.npy")),
                      GRAPH_PARTS)
    out = {"decomp_s": time.perf_counter() - t,
           "decomp_host_peak_GB": _peak_host_gb(), "stats": {}, "ms": {},
           "c_max": dec.c_max, "n_cut": dec.n_cut, "e_max": dec.e_max,
           "owned": int(dec.owned_counts[rank])}
    if rank == 0:
        np.save(os.path.join(tmp, "owned_gid.npy"), dec.owned_gid)
    mesh = make_dpc_mesh(GRAPH_PARTS, device=device)
    gid = dec.owned_gid[rank, :dec.owned_counts[rank]]
    masks = {"top10": torch.from_numpy(np.load(os.path.join(
        tmp, "tet_mask.npy"))).to(device),
        "ones": torch.ones(n, dtype=torch.bool, device=device)}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _zero_fused_launches()
    for name, m in masks.items():
        want = torch.from_numpy(np.load(os.path.join(
            tmp, f"tet_pure_{name}.npy"))[gid])
        first = None
        for mode in MODES:
            for gm in (True, False):
                got, stats = distributed_connected_components_graph(
                    m, dec, mesh, gather_mask=gm, table_mode=mode)
                out["stats"][f"{name} {mode} gather_mask={gm}"] = \
                    stats.as_dict()
                got = got.cpu()
                if first is None:
                    first = got
                    np.save(os.path.join(tmp, f"tet_{name}_{rank}.npy"),
                            got.numpy())
                check(torch.equal(got, first) and torch.equal(got, want),
                      f"10a rank {rank} {name} {mode} gather_mask={gm}: "
                      f"labels == the pure graph cc's at its vertices")
    out["launches"] = _fused_launches()
    if on_card:
        torch.cuda.synchronize()
        out["device_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        for mode in MODES:
            out["ms"][mode] = event_ms(
                lambda: distributed_connected_components_graph(
                    masks["top10"], dec, mesh, table_mode=mode), 3)
    out["host_peak_GB"] = _peak_host_gb()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _rank_10b(rank, store, tmp, n, device):
    """Phase 10b, one of `RANDOM_PARTS` ranks sharing the card over gloo:
    random_1m's GraphDecomp (every partition adjacent to every other, so
    the sharded schedule runs at the largest degree), then in both table
    modes a batched cc of the `RANDOM_BATCH_QS` masks, each item == its
    single call (labels and stats).  Writes the batch's labels and stats
    to `tmp`."""
    import torch
    import torch.distributed as dist
    _rank_setup(rank, RANDOM_PARTS, store, "gloo", device)
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.core.distributed_graph import (
        GraphDecomp, _graph_shard_geom,
        distributed_connected_components_graph,
        distributed_connected_components_graph_batch)
    t = time.perf_counter()
    dec = GraphDecomp(n, np.load(os.path.join(tmp, "rand_send.npy")),
                      np.load(os.path.join(tmp, "rand_recv.npy")),
                      RANDOM_PARTS)
    geom = _graph_shard_geom(dec)
    out = {"decomp_s": time.perf_counter() - t, "d_max": geom.d_max,
           "rounds": len(geom.round_perms), "stats": {}}
    if rank == 0:
        np.save(os.path.join(tmp, "rand_owned_gid.npy"), dec.owned_gid)
    mesh = make_dpc_mesh(RANDOM_PARTS, device=device)
    masks = torch.from_numpy(np.load(os.path.join(
        tmp, "rand_masks.npy"))).to(device)
    _zero_fused_launches()
    for mode in MODES:
        got, stats = distributed_connected_components_graph_batch(
            masks, dec, mesh, table_mode=mode)
        for b, m in enumerate(masks):
            want, st = distributed_connected_components_graph(
                m, dec, mesh, table_mode=mode)
            check(torch.equal(got[b], want) and all(
                getattr(stats, f)[b].item() == v.item()
                for f, v in zip(st._fields, st)),
                f"10b rank {rank} {mode}: batch item {b} == its single call")
        out["stats"][mode] = stats.as_dict()
        np.save(os.path.join(tmp, f"rand_{mode}_{rank}.npy"),
                got.cpu().numpy())
    out["launches"] = _fused_launches()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def distributed_graph_path(smi, g, dev):
    """Phase 10: the distributed graph backend
    (`repro_torch.core.distributed_graph`) on the card, gloo ranks sharing
    it (`dev`; a CPU device runs the same ranks on the CPU: a rehearsal at
    small sizes).  `g` holds phase 8's inputs and pure labels on the host.
    10a: the tet mesh over `GRAPH_PARTS` contiguous partitions, top-10% and
    geometry cc in both table modes, the mask gathered and not, the
    assembled labels == phase 8's; each rank's GraphDecomp host time and
    peak host and device memory.  10b: random_1m over `RANDOM_PARTS`, a
    batch of four masks in both table modes == its single calls, the first
    two == phase 8's.  The graph path launches no kernel: every count is
    read as 0.  Returns the fused kernel's launches by sub-phase."""
    import shutil
    import tempfile
    import types
    import torch.multiprocessing as mp
    from repro_torch.core.distributed_graph import assemble_graph_labels
    from repro_torch.data import quantile
    import torch

    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    try:
        # 10a. the tet mesh, two ranks ------------------------------------
        t0 = time.perf_counter()
        n = g["tet_mask"].size
        for k in ("tet_send", "tet_recv", "tet_mask"):
            np.save(os.path.join(tmp, f"{k}.npy"), g[k])
        for k, v in g["tet_pure"].items():
            np.save(os.path.join(tmp, f"tet_pure_{k}.npy"), v)
        print(f"  10a tet mesh {TET_DIMS}: {n} vertices, "
              f"{g['tet_send'].size} directed edges over {GRAPH_PARTS} "
              f"contiguous partitions, gloo ranks sharing the card")
        mp.spawn(_rank_10a, args=(os.path.join(tmp, "store_10a"), tmp, n,
                                  dev.type), nprocs=GRAPH_PARTS, join=True)
        outs = []
        for rank in range(GRAPH_PARTS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        owned = np.load(os.path.join(tmp, "owned_gid.npy"))
        dec = types.SimpleNamespace(n=n, owned_gid=owned, owned_counts=[
            o["owned"] for o in outs])
        for name, want in g["tet_pure"].items():
            got = assemble_graph_labels([np.load(os.path.join(
                tmp, f"tet_{name}_{rank}.npy")) for rank in
                range(GRAPH_PARTS)], dec).numpy()
            n_bad = int((got != want).sum())
            check(got.dtype == np.int32 and n_bad == 0,
                  f"10a {name}: assembled labels == phase 8's pure graph cc "
                  f"({n_bad} differ)")
        check(all(o["stats"] == outs[0]["stats"] for o in outs),
              "10a: every rank reports the same stats")
        for key, st in outs[0]["stats"].items():
            check(st["converged"] == 1 and st["comm_phases"] >= 1,
                  f"10a {key} converged through the table")
            print(f"  10a {key}: assembled labels == pure, stats {st}")
        launches["10a"] = {k: sum(o["launches"][k] for o in outs)
                           for k in ("manifold", "cc")}
        check(launches["10a"] == {"manifold": 0, "cc": 0},
              "10a: the graph path launches no kernel")
        for rank, o in enumerate(outs):
            print(f"  10a rank {rank}: GraphDecomp {o['decomp_s']:.3f} s on "
                  f"the host ({o['owned']} owned vertices, e_max "
                  f"{o['e_max']}, c_max {o['c_max']}, {o['n_cut']} cut "
                  f"vertices in all), peak host memory "
                  f"{o['decomp_host_peak_GB']:.3f} GB after it and "
                  f"{o['host_peak_GB']:.3f} GB at the end, peak device "
                  f"memory {o.get('device_peak_GB')} GB; top-10% cc warm "
                  f"{ {m: round(v, 3) for m, v in o['ms'].items()} } ms "
                  f"(median of 3, CUDA events; two processes time-share "
                  f"one card, gloo stages every exchange through the host) "
                  f"({smi})")
        phase("distributed graph 10a: tet mesh, two ranks, gloo", t0)

        # 10b. random_1m, eight ranks ------------------------------------
        t0 = time.perf_counter()
        # on the card, as phase 8 made its masks
        field = torch.from_numpy(g["rand_field"]).to(dev)
        masks = np.stack([np.ones(field.numel(), bool) if qq is None
                          else (field > quantile(field, qq)).cpu().numpy()
                          for qq in RANDOM_BATCH_QS])
        del field
        n = masks.shape[1]
        np.save(os.path.join(tmp, "rand_send.npy"), g["rand_send"])
        np.save(os.path.join(tmp, "rand_recv.npy"), g["rand_recv"])
        np.save(os.path.join(tmp, "rand_masks.npy"), masks)
        mp.spawn(_rank_10b, args=(os.path.join(tmp, "store_10b"), tmp, n,
                                  dev.type), nprocs=RANDOM_PARTS, join=True)
        outs = []
        for rank in range(RANDOM_PARTS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        check(outs[0]["d_max"] == RANDOM_PARTS - 1,
              f"10b: every partition is adjacent to every other (d_max "
              f"{outs[0]['d_max']}, {outs[0]['rounds']} permute rounds)")
        check(all(o["stats"] == outs[0]["stats"] for o in outs),
              "10b: every rank reports the same stats")
        owned = np.load(os.path.join(tmp, "rand_owned_gid.npy"))
        counts = [int((row < n).sum()) for row in owned]
        dec = types.SimpleNamespace(n=n, owned_gid=owned,
                                    owned_counts=counts)
        for mode in MODES:
            got = assemble_graph_labels([np.load(os.path.join(
                tmp, f"rand_{mode}_{rank}.npy")) for rank in
                range(RANDOM_PARTS)], dec).numpy()
            for b, key in enumerate(("ones", "top10")):
                n_bad = int((got[b] != g["rand_pure"][key]).sum())
                check(n_bad == 0, f"10b {mode} batch item {b} ({key}) == "
                      f"phase 8's pure graph cc ({n_bad} differ)")
            print(f"  10b {mode}: batch of {len(RANDOM_BATCH_QS)} masks == "
                  f"its single calls on every rank, items 0-1 == phase 8's "
                  f"pure labels; stats {outs[0]['stats'][mode]}")
        launches["10b"] = {k: sum(o["launches"][k] for o in outs)
                           for k in ("manifold", "cc")}
        check(launches["10b"] == {"manifold": 0, "cc": 0},
              "10b: the graph path launches no kernel")
        print(f"  10b random_1m over {RANDOM_PARTS} partitions: d_max "
              f"{outs[0]['d_max']}, {outs[0]['rounds']} permute rounds a "
              f"sharded exchange; GraphDecomp "
              f"{max(o['decomp_s'] for o in outs):.3f} s (slowest rank)")
        phase("distributed graph 10b: random_1m, eight ranks, gloo", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def distributed_path(smi, host, conn, q, dev):
    """Phase 9: the distributed grid backend (`repro_torch.core.distributed`)
    on the card (`dev`; with a CPU device, 9a runs over gloo and nothing is
    timed: a rehearsal at small sizes).  `host` holds phase 4's order, mask
    and pure labels on the host.  Returns the fused kernel's launches by
    sub-phase, and by sub-phase and mode the (max abs error, rounds) of its
    ghost-masked launches held to the plain version (on the card only)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.distributed import _decomp_for, make_dpc_mesh
    from repro_torch.core.ids import compute_order
    from repro_torch.core.ms_segmentation import ms_segmentation
    from repro_torch.data import perlin_noise, quantile

    on_card = dev.type == "cuda"
    launches, fused = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # 9a. one rank over NCCL at 512^3: one 514^3 extended block ------
        t0 = time.perf_counter()
        shape = tuple(host["order"].shape)
        block = (host["order"].to(dev), host["mask"].to(dev))
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(os.path.join(
                                    tmp, "store_9a"), 1), rank=0,
                                world_size=1)
        try:
            mesh = make_dpc_mesh((1, 1, 1), device=dev)
            _zero_fused_launches()
            peak, kernel_rounds, direct = {}, {}, {}
            for mode in ("replicated", "sharded"):
                for query, want in (("desc", "descending"),
                                    ("asc", "ascending"), ("cc", "labels")):
                    if on_card:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    got, stats = _dist_query(query, block, mesh, shape, conn,
                                             mode)
                    if on_card:
                        torch.cuda.synchronize()
                        peak[f"{query} {mode}"] = \
                            torch.cuda.max_memory_allocated() / 1e9
                    check(torch.equal(got.cpu(), host[want]),
                          f"9a {query} {mode}: labels == the pure path's "
                          f"(phase 4)")
                    print(f"  9a {query} {mode}: labels == pure, stats "
                          f"{stats.as_dict()}, peak device memory "
                          f"{peak.get(f'{query} {mode}')} GB ({smi})")
                    kernel_rounds[mode, query] = int(stats.kernel_rounds)
                    direct[query, mode] = stats.as_dict()
                    del got
            launches["9a"] = _fused_launches()
            print(f"  9a fused kernel launches (1 rank, {mesh.backend}, "
                  f"extended block {tuple(n + 2 for n in shape)}, 6 calls): "
                  f"{launches['9a']}")
            check(not on_card or launches["9a"] == {"manifold": 4, "cc": 2},
                  "9a: each distributed call launched the fused kernel once")
            if on_card:
                # the path's launch on the 514^3 block against the plain
                # version, and the rounds the stats reported for it
                fused["9a"] = _ghost_masked_vs_plain(
                    block, _decomp_for(mesh, shape), mesh, conn, "9a")
                for mode in ("replicated", "sharded"):
                    for query, kind in (("desc", "manifold"), ("cc", "cc")):
                        check(kernel_rounds[mode, query]
                              == fused["9a"][kind][1],
                              f"9a {query} {mode}: stats kernel_rounds "
                              f"{kernel_rounds[mode, query]} == the "
                              f"launch's {fused['9a'][kind][1]}")
                print(f"  9a ghost-masked fused launch on the "
                      f"{tuple(n + 2 for n in shape)} extended block == "
                      f"plain (pointers and rounds; max err, rounds): "
                      f"{fused['9a']}")
                torch.cuda.empty_cache()
            launches["9a facade"], fused["9a facade"] = _facade_9a(
                smi, host, block, mesh, shape, conn, direct, dev)
            if on_card:
                torch.cuda.empty_cache()
            for mode in ("replicated", "sharded") if on_card else ():
                ms_ms = event_ms(lambda: [_dist_query(
                    qq, block, mesh, shape, conn, mode)
                    for qq in ("desc", "asc")], 3)
                cc_ms = event_ms(lambda: _dist_query(
                    "cc", block, mesh, shape, conn, mode), 3)
                print(f"  9a {mode}: distributed ms (both manifolds) "
                      f"{ms_ms:.3f} ms, cc {cc_ms:.3f} ms (warm, median of "
                      f"3, CUDA events; pure ms query "
                      f"{host['ms_query_ms']:.3f} ms, cc query "
                      f"{host['cc_query_ms']:.3f} ms, phase 6) ({smi})")
            if on_card:
                profile(lambda: _dist_query("cc", block, mesh, shape, conn,
                                            "replicated"),
                        "9a distributed cc, 1 rank, replicated", top=10)
        finally:
            dist.destroy_process_group()
        del block
        if on_card:
            torch.cuda.empty_cache()
        phase("distributed 9a: one rank, NCCL, 512^3", t0)

        # 9b. two ranks sharing the card over gloo: 512^3 blocks ----------
        t0 = time.perf_counter()
        shape_b, half = DIST_B_SHAPE, DIST_B_SHAPE[0] // 2
        field = perlin_noise(shape_b, frequency=0.1, seed=SEED, device=dev)
        order = compute_order(field)
        mask = field > quantile(field, q)
        mask2 = field > quantile(field, DIST_B_BATCH_Q)
        del field
        pure = ms_segmentation(order, conn)
        want = {"desc": pure.descending.cpu().numpy(),
                "asc": pure.ascending.cpu().numpy()}
        del pure
        want["cc"] = connected_components_grid(mask, conn).labels.cpu(
            ).numpy()
        for rank in range(2):
            sl = slice(rank * half, (rank + 1) * half)
            np.save(os.path.join(tmp, f"order{rank}.npy"),
                    order[sl].cpu().numpy())
            np.save(os.path.join(tmp, f"mask{rank}.npy"),
                    mask[sl].cpu().numpy())
            np.save(os.path.join(tmp, f"mask2_{rank}.npy"),
                    mask2[sl].cpu().numpy())
        print(f"  9b grid {shape_b}: {int(mask.sum())} masked voxels; pure "
              f"path on the card before spawning")
        del order, mask, mask2
        if on_card:
            torch.cuda.empty_cache()
        mp.spawn(_rank_9b, args=(os.path.join(tmp, "store_9b"), tmp,
                                 shape_b, conn, dev.type), nprocs=2,
                 join=True)
        outs = []
        for rank in range(2):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        for query in ("desc", "asc", "cc"):
            got = np.concatenate([np.load(os.path.join(
                tmp, f"got_{query}{rank}.npy")) for rank in range(2)])
            n_bad = int((got != want[query]).sum())
            check(got.dtype == np.int32 and n_bad == 0,
                  f"9b {query}: gathered labels == the pure path's over "
                  f"{shape_b} ({n_bad} differ)")
        check(outs[0]["stats"] == outs[1]["stats"],
              "9b: both ranks report the same stats")
        for key, s in outs[0]["stats"].items():
            check(s["converged"] == 1, f"9b {key} converged")
            print(f"  9b {key}: labels == pure, stats {s}")
        launches["9b"] = {k: sum(o["launches"][k] for o in outs)
                          for k in ("manifold", "cc")}
        check(not on_card or launches["9b"] == {"manifold": 8, "cc": 4},
              "9b: every distributed call launched the fused kernel once a "
              "rank")
        launches["9b batch"] = {k: sum(o["batch_launches"][k] for o in outs)
                                for k in ("manifold", "cc")}
        check(not on_card or launches["9b batch"] == {"manifold": 0,
                                                      "cc": 4},
              "9b batch: the fused kernel launched once a mask a rank")
        check(outs[0]["batch_stats"] == outs[1]["batch_stats"],
              "9b batch: both ranks report the same stats")
        print(f"  9b batched cc, B = 2 (top 10% and top 20%): items == "
              f"their single calls on both ranks; collectives of the batch "
              f"{outs[0]['batch_counts']} == of one single call "
              f"{outs[0]['single_counts']}; stats {outs[0]['batch_stats']}")
        if on_card:
            fused["9b"] = {kind: (max(o["fused"][kind][0] for o in outs),
                                  max(o["fused"][kind][1] for o in outs))
                           for kind in ("manifold", "cc")}
            for key, s in outs[0]["stats"].items():
                kind = "cc" if key.startswith("cc") else "manifold"
                check(key.startswith("asc")
                      or s["kernel_rounds"] == fused["9b"][kind][1],
                      f"9b {key}: stats kernel_rounds {s['kernel_rounds']} "
                      f"== the ranks' largest {fused['9b'][kind][1]}")
            print(f"  9b ghost-masked fused launches on the {half + 2}x"
                  f"{shape_b[1]}x{shape_b[2]} extended blocks == plain on "
                  f"both ranks (pointers and rounds; max err, largest "
                  f"rounds): {fused['9b']}")
        for key in outs[0]["ms"]:
            print(f"  9b {key}: {max(o['ms'][key] for o in outs):.3f} ms "
                  f"(slower rank, warm, median of 3, CUDA events; two "
                  f"processes time-share one card and every exchange is "
                  f"staged through the host by gloo: a full-width "
                  f"correctness run, not a scaling figure) ({smi})")
        print(f"  9b per-rank peak device memory: "
              f"{[o.get('peak_GB') for o in outs]} GB ({smi})")
        print(f"  9b fused kernel launches (2 ranks, {half + 2}x"
              f"{shape_b[1]}x{shape_b[2]} extended blocks): "
              f"{launches['9b']}")
        phase("distributed 9b: two ranks, gloo, 512^3 blocks", t0)

        # 9c. eight ranks sharing the card over gloo, layout (2, 2, 2) ------
        t0 = time.perf_counter()
        mp.spawn(_rank_9c, args=(os.path.join(tmp, "store_9c"), tmp,
                                 DIST_C_CASES, dev.type), nprocs=8, join=True)
        outs = []
        for rank in range(8):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        launches["9c"] = {k: sum(o["launches"][k] for o in outs)
                          for k in ("manifold", "cc")}
        if on_card:
            fused["9c"] = {k: (max(o["fused_err"][k] for o in outs), None)
                           for k in ("manifold", "cc")}
        n_calls = 8 * len(DIST_C_CASES) * 8   # ranks x cases x calls a kind
        check(not on_card or launches["9c"] == {"manifold": n_calls,
                                                "cc": n_calls},
              "9c: every distributed call launched the fused kernel once a "
              "rank")
        print(f"  9c {[c[0] for c in DIST_C_CASES]} over (2, 2, 2), "
              f"connectivity 6 and "
              f"26, both table modes, mask gathered and not: labels == the "
              f"pure path's on every rank, stats == their closed forms; "
              f"{sum(o['fused_compared'] for o in outs)} ghost-masked fused "
              f"launches == plain (pointers and rounds); fused kernel "
              f"launches {launches['9c']}")
        phase("distributed 9c: eight ranks, gloo, ragged", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, fused


def _serve_launch_sums(engine, runs_before=None):
    """{kind: slots} the pure grid executables of `engine` ran since
    `runs_before` (a `runs_per_executable` snapshot): capacity times
    executions.  The fused kernel launches once a slot, dummies included."""
    before = runs_before or {}
    out = {"manifold": 0, "cc": 0}
    for key, runs in engine.cache_info()["runs_per_executable"].items():
        if key[:2] == ("grid", "pure"):
            out[key[2]] += key[-2] * (runs - before.get(key, 0))
    return out


def _serve_same(got, want, what):
    """Query, tag, every label field (bit for bit, dtype, device) and the
    stats of two TopologyResults."""
    check((got.query, got.tag) == (want.query, want.tag), f"{what}: query "
          f"and tag")
    for f in ("labels", "ascending", "descending", "segmentation"):
        a, b = getattr(got, f), getattr(want, f)
        check((a is None) == (b is None) and (
            a is None or (a.device == b.device and a.dtype == b.dtype
                          and a.shape == b.shape
                          and bool((a == b).all()))),
              f"{what}: {f} == the facade's, bit for bit")
    check(got.stats == want.stats, f"{what}: stats == the facade's")


def _serve_open_loop(engine, trace, reqs):
    """Drive an async engine through a trace's arrivals; returns the
    handles after the final drain."""
    handles = []
    for req, (t, dl) in zip(reqs, trace.arrivals):
        if t > engine.clock.now():
            engine.advance(t - engine.clock.now())
        handles.append(engine.submit(req, deadline=dl))
    engine.drain()
    return handles


def _latency_text(engine):
    lat = np.asarray(engine.latencies) * 1e3
    if lat.size == 0:
        return "no completed request"
    return (f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
            f"{np.percentile(lat, 99):.3f} ms (virtual clock charged with "
            f"measured execution time)")


def _rank_11e(rank, store, tmp, device):
    """Phase 11e, one of eight ranks sharing the card over gloo, layout
    (2, 2, 2): 97x61x43 at connectivity 6 and 26 in both table modes, a cc,
    an ms, an ascending manifold and a sweep of three thresholds through
    the sync engine, each result == this rank's facade result (labels and
    stats); the first of these four sets also through the async engine on
    a VirtualClock, where an ms request with table_max_iter=1 fails alone;
    the clock guard raises ValueError for a MonotonicClock.  On the card,
    the ghost-masked fused launch on this rank's real block and on an inert
    dummy block (the manifold bucket's capacity slot) is held to the plain
    version.  Writes its fused launches and errors to `tmp`."""
    import dataclasses
    import torch
    import torch.distributed as dist
    _rank_setup(rank, 8, store, "gloo", device)
    from repro_torch.core.distributed import _decomp_for, make_dpc_mesh
    from repro_torch.core.ids import compute_order
    from repro_torch.serve import (AsyncTopologyEngine, MonotonicClock,
                                   TopologyEngine, VirtualClock)
    from repro_torch.topology import TopologyRequest, submit_many
    mesh = make_dpc_mesh((2, 2, 2), device=device)
    dec = _decomp_for(mesh, RAGGED)
    sl = dec.block_slices(mesh.coords)
    rng = np.random.default_rng(SERVE_E_SEED)
    field = rng.standard_normal(RAGGED).astype(np.float32)
    mask = rng.random(RAGGED) < 0.3
    thr = np.quantile(field, SERVE_E_QS).astype(np.float32)
    order = compute_order(torch.from_numpy(field).to(device))

    def blk(x):
        return torch.as_tensor(x, device=device)[sl].contiguous()

    launches = {"manifold": 0, "cc": 0}
    for conn in (6, 26):
        for mode in MODES:
            what = f"11e rank {rank} conn {conn} {mode}"
            base = dict(backend="distributed", mesh=mesh, grid_shape=RAGGED,
                        connectivity=conn, table_mode=mode)
            reqs = [TopologyRequest("cc", mask=blk(mask), tag="cc", **base),
                    TopologyRequest("ms", order=blk(order), tag="ms",
                                    **base),
                    TopologyRequest("manifold", order=blk(order),
                                    descending=False, tag="asc", **base),
                    TopologyRequest("threshold_sweep", field=blk(field),
                                    thresholds=thr, tag="sweep", **base)]
            want = submit_many(reqs)
            _zero_fused_launches()
            got = TopologyEngine(device=device).submit_batch(reqs)
            sync_launches = _fused_launches()
            for k in launches:
                launches[k] += sync_launches[k]
            # cc: the cc and the three sweep masks; manifold: the ms's two
            # directions and the flipped manifold, one dummy slot
            check(device != "cuda" or sync_launches == {"manifold": 4,
                                                        "cc": 4},
                  f"{what}: one launch a slot ({sync_launches})")
            for g, w in zip(got, want):
                _serve_same(g, w, f"{what} sync {w.tag}")
            if (conn, mode) != (6, MODES[0]):
                continue
            eng = AsyncTopologyEngine(max_batch=4, clock=VirtualClock(),
                                      device=device)
            hs = [eng.submit(r, deadline=0.5 * (i + 1))
                  for i, r in enumerate(reqs)]
            eng.advance(1.0)        # a deadline flush, then the drain
            eng.drain()
            for h, w in zip(hs, want):
                check(h.exception() is None, f"{what} async {w.tag}: "
                      f"{h.exception()!r}")
                _serve_same(h.result(), w, f"{what} async {w.tag}")
            bad = dataclasses.replace(reqs[1], table_max_iter=1, tag="bad")
            hb, hg = eng.submit(bad), eng.submit(reqs[0])
            eng.drain()
            s = eng.stats
            check(isinstance(hb.exception(), RuntimeError)
                  and "max_iter" in str(hb.exception())
                  and hg.exception() is None and s.failures == 1
                  and s.batches == (s.flush_capacity + s.flush_deadline
                                    + s.flush_drain + s.flush_retry)
                  and s.flush_deadline >= 1,
                  f"{what}: the table_max_iter=1 request fails alone "
                  f"({hb.exception()!r}, {s.as_dict()})")
            _serve_same(hg.result(), want[0], f"{what} async after failure")
    try:
        AsyncTopologyEngine(clock=MonotonicClock(), device=device).submit(
            reqs[0])
        guard = "no error"
    except ValueError as e:
        guard = "ValueError" if "VirtualClock" in str(e) else str(e)
    check(guard == "ValueError", f"11e rank {rank}: the clock guard raises "
          f"ValueError for a MonotonicClock ({guard})")
    err = {"manifold": 0, "cc": 0}
    if device == "cuda":
        ob, mb = blk(order), blk(mask)
        for conn in (6, 26):
            for name, block in (("real", (ob, mb)),
                                ("dummy", (torch.full_like(ob, -1),
                                           torch.zeros_like(mb)))):
                fused = _ghost_masked_vs_plain(
                    block, dec, mesh, conn, f"11e rank {rank} {name} block")
                for kind, (e, _) in fused.items():
                    err[kind] = max(err[kind], e)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "fused_err": err}, f)
    dist.destroy_process_group()


def _serve_slots_vs_plain(engine, reqs):
    """Serve `reqs` on `engine` with its execution seam wrapped: before each
    pure grid execution, every slot of the stacked padded batch (the real
    payloads in their pow2 layout, then the all-inert dummy slots) goes
    through the fused kernel and its plain version, pointers and rounds
    exactly equal.  Returns ({kind: (max abs error, max rounds)}, {kind:
    slots compared}, {kind: dummy slots among them}, layouts seen)."""
    from repro_torch.kernels import fused_local_phase as kmod, ref
    err = {"manifold": (0, 0), "cc": (0, 0)}
    n = {"manifold": 0, "cc": 0}
    dummies = {"manifold": 0, "cc": 0}
    layouts = set()
    inner = engine._execute

    def execute(fn, group, args):
        g0 = group[0]
        if (g0.domain, g0.backend) == ("grid", "pure"):
            stack = args[0]
            layouts.add((g0.kind, tuple(stack.shape[1:]), len(stack)))
            for pos, x in enumerate(stack):
                got, r = kmod.fused_local_phase(x, g0.connectivity,
                                                mode=g0.kind)
                want, wr = ref.fused_local_phase_ref(x, g0.connectivity,
                                                     mode=g0.kind)
                e = int((got.long() - want.long()).abs().max())
                slot = "dummy" if pos >= len(group) else "real"
                check(got.dtype == want.dtype and e == 0 and r == wr,
                      f"11a {g0.kind} {slot} slot {pos} of a "
                      f"{tuple(stack.shape)} stack: kernel == plain (max "
                      f"err {e}, rounds {r} vs {wr})")
                err[g0.kind] = (max(err[g0.kind][0], e),
                                max(err[g0.kind][1], r))
                n[g0.kind] += 1
                dummies[g0.kind] += pos >= len(group)
        return inner(fn, group, args)

    engine._execute = execute
    try:
        engine.submit_batch(reqs)
    finally:
        engine._execute = inner
    return err, n, dummies, layouts


def serve_path(smi, host, conn, dev):
    """Phase 11: the serving engine (`repro_torch.serve`) on the card (`dev`;
    a CPU device runs it on the CPU with nothing timed and no launch
    counted: a rehearsal at small sizes).  11a the sync engine at
    `configs/serve_topology.py`'s full widths, cold and warm; 11b the async
    plane on the same trace; 11c overload at `overload_factor` times 11a's
    warm rate; 11d the distributed engine on one NCCL rank at phase 4's
    512^3 block; 11e eight gloo ranks on 97x61x43.  `host` holds phase 4's
    order and pure labels.  Returns the fused kernel's launches by
    sub-phase, and by sub-phase and mode the (max abs error, rounds) of its
    launches on 11a's stacked slots and 11e's blocks held to the plain
    version (on the card only)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.serve_topology import full_config
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.data import perlin_noise, quantile
    from repro_torch.serve import (AsyncTopologyEngine, DeadlineShed,
                                   Overloaded, PlaneError, TopologyEngine,
                                   VirtualClock)
    from repro_torch.serve.workload import (overload_trace,
                                            synthetic_requests,
                                            synthetic_trace)
    from repro_torch.topology import TopologyRequest, submit, submit_many

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_gb(reset=False):
        if not on_card:
            return None
        if reset:
            torch.cuda.reset_peak_memory_stats()
            return None
        return torch.cuda.max_memory_allocated() / 1e9

    cfg = full_config()
    launches = {}
    engine_kw = dict(min_extent=cfg.min_extent, max_batch=cfg.max_batch,
                     cache_capacity=cfg.cache_capacity,
                     slot_cost_cells=cfg.slot_cost_cells or None, device=dev)

    # 11a. the sync engine, cold then warm --------------------------------
    t0 = time.perf_counter()
    reqs = synthetic_requests(SERVE_N, cfg.shapes, cfg.mix, cfg.connectivity,
                              cfg.sweep_k, seed=SERVE_SEED, device=dev)
    eng = TopologyEngine(**engine_kw)
    passes = {}
    for name in ("cold", "warm"):
        runs0 = dict(eng.cache_info()["runs_per_executable"])
        before = {k: getattr(eng.stats, k) for k in
                  ("cache_misses", "cache_hits", "batches")}
        sync()
        peak_gb(reset=True)
        _zero_fused_launches()
        t = time.perf_counter()
        got = eng.submit_batch(reqs)
        sync()
        secs = time.perf_counter() - t
        launches[f"11a {name}"] = _fused_launches()
        slots = _serve_launch_sums(eng, runs0)
        check(not on_card or launches[f"11a {name}"] == slots,
              f"11a {name}: fused launches {launches[f'11a {name}']} == the "
              f"grid buckets' capacity sum {slots}")
        passes[name] = dict(secs=secs, peak=peak_gb(), slots=slots, got=got,
                            batches=eng.stats.batches - before["batches"],
                            misses=eng.stats.cache_misses
                            - before["cache_misses"],
                            hits=eng.stats.cache_hits - before["cache_hits"])
    warm = passes["warm"]
    check(warm["misses"] == 0 and warm["hits"] == warm["batches"],
          f"11a warm replay builds nothing and hits on every bucket "
          f"({warm['misses']} builds, {warm['hits']} hits, "
          f"{warm['batches']} executions)")
    t = time.perf_counter()
    want = submit_many(reqs, dev)
    sync()
    seq_s = time.perf_counter() - t
    for name in ("cold", "warm"):
        for i, (g, w) in enumerate(zip(passes[name].pop("got"), want)):
            _serve_same(g, w, f"11a {name} request {i} ({w.query})")
    st = eng.stats
    warm_rps = SERVE_N / warm["secs"]
    layouts = sorted({(k[2], k[5], k[-2]) for k in
                      eng.cache_info()["runs_per_executable"]})
    print(f"  11a {SERVE_N} requests ({st.items // 2} items a pass) at "
          f"{cfg.shapes}, mix {cfg.mix}, sweep_k {cfg.sweep_k}, max_batch "
          f"{cfg.max_batch}: engine == submit_many bit for bit, cold and "
          f"warm; {len(eng._exec)} executables (kind, layout, capacity): "
          f"{layouts}")
    for name, p in passes.items():
        print(f"  11a {name}: {p['secs'] * 1e3:.3f} ms, "
              f"{SERVE_N / p['secs']:.3f} requests/s, {p['batches']} "
              f"executions, {p['misses']} builds, {p['hits']} hits, fused "
              f"launches {launches[f'11a {name}']} == capacity sum "
              f"{p['slots']}, peak device memory {p['peak']} GB ({smi})")
    fused = {}
    if on_card:
        # outside the launch windows, on an engine of its own (its stats
        # stay apart): every slot the fused kernel saw in a pass, as stacked
        # and padded, held to the plain version
        fused["11a"], n_cmp, n_dummy, seen = _serve_slots_vs_plain(
            TopologyEngine(**engine_kw), reqs)
        check(n_cmp == warm["slots"] and seen == set(layouts),
              f"11a: the slot check saw every slot of every executable "
              f"({n_cmp} against {warm['slots']}; {sorted(seen)})")
        print(f"  11a every slot of a pass through the fused kernel and its "
              f"plain version, as stacked and padded: {n_cmp} slots, of "
              f"which {n_dummy} dummy; pointers and rounds equal, (max err, "
              f"max rounds) {fused['11a']}")
    print(f"  11a sequential facade (submit_many): {seq_s * 1e3:.3f} ms, "
          f"{SERVE_N / seq_s:.3f} requests/s; engine hit rate "
          f"{st.hit_rate:.3f}, pad fraction {st.pad_fraction:.6f} "
          f"({st.real_cells // 2} real of {st.padded_cells // 2} executed "
          f"cells a pass) ({smi})")
    if on_card:
        # the first SERVE_PROFILED requests on an engine of their own,
        # warmed once: a whole pass is ~40,000 profiler events, ~40 s of
        # the profiler's own bookkeeping
        sub = reqs[:SERVE_PROFILED]
        peng = TopologyEngine(**engine_kw)
        peng.submit_batch(sub)
        profile(lambda: peng.submit_batch(sub),
                f"11a warm pass of the first {SERVE_PROFILED} requests",
                top=8)
        del peng, sub
    phase("serve 11a: sync engine, full widths", t0)

    # 11b. the async plane on the same trace ------------------------------
    t0 = time.perf_counter()
    trace = synthetic_trace(SERVE_N, cfg.shapes, cfg.mix, cfg.connectivity,
                            cfg.sweep_k, seed=SERVE_SEED, rate=cfg.rate,
                            deadline_slack=cfg.deadline_slack)
    aeng = AsyncTopologyEngine(clock=VirtualClock(),
                               charge_execution_time=True, **engine_kw)
    _zero_fused_launches()
    handles = _serve_open_loop(aeng, trace, trace.requests(device=dev))
    sync()
    launches["11b"] = _fused_launches()
    check(not on_card or launches["11b"] == _serve_launch_sums(aeng),
          f"11b: fused launches {launches['11b']} == the capacity sum")
    for i, (h, w) in enumerate(zip(handles, want)):
        check(h.done() and h.exception() is None,
              f"11b request {i}: {h.exception()!r}")
        _serve_same(h.result(), w, f"11b request {i} ({w.query})")
    s = aeng.stats
    check(s.batches == s.flush_capacity + s.flush_deadline + s.flush_drain
          + s.flush_retry, "11b: the flush reasons sum to the executions")
    print(f"  11b open loop, rate {cfg.rate}/s, deadline slack "
          f"{cfg.deadline_slack} s: {s.completed} handles == submit_many; "
          f"{s.batches} executions (capacity {s.flush_capacity}, deadline "
          f"{s.flush_deadline}, drain {s.flush_drain}, retry "
          f"{s.flush_retry}); deadline hit rate {s.deadline_hit_rate:.3f}; "
          f"{_latency_text(aeng)}; virtual clock at "
          f"{aeng.clock.now():.3f} s ({smi})")
    phase("serve 11b: async plane", t0)

    # 11c. overload at `overload_factor` x the warm rate --------------------
    # shed_policy "hopeless" (the config's overload run), then "never" on
    # the same trace: admission alone refuses work and deadline flushes fire
    t0 = time.perf_counter()
    otrace = overload_trace(SERVE_N, cfg.shapes, cfg.mix, cfg.connectivity,
                            cfg.sweep_k, seed=SERVE_SEED,
                            sustainable_rps=warm_rps,
                            factor=cfg.overload_factor)
    for policy in ("hopeless", "never"):
        oeng = AsyncTopologyEngine(clock=VirtualClock(),
                                   charge_execution_time=True,
                                   max_queue_depth=cfg.overload_queue_depth,
                                   shed_policy=policy, **engine_kw)
        _zero_fused_launches()
        handles = _serve_open_loop(oeng, otrace, otrace.requests(device=dev))
        sync()
        launches[f"11c {policy}"] = _fused_launches()
        check(not on_card
              or launches[f"11c {policy}"] == _serve_launch_sums(oeng),
              f"11c {policy}: fused launches {launches[f'11c {policy}']} "
              f"== the capacity sum")
        for i, (h, w) in enumerate(zip(handles, want)):
            check(h.done(), f"11c {policy} request {i} resolved")
            if h.exception() is None:
                _serve_same(h.result(), w,
                            f"11c {policy} request {i} ({w.query})")
            else:
                check(isinstance(h.exception(), (Overloaded, DeadlineShed)),
                      f"11c {policy} request {i}: a typed plane error "
                      f"({h.exception()!r})")
        s = oeng.stats
        n_over = sum(isinstance(h.exception(), Overloaded) for h in handles)
        n_shed = sum(isinstance(h.exception(), DeadlineShed)
                     for h in handles)
        check(s.completed + s.failures + s.shed == s.requests
              and s.rejected == n_over and s.shed == n_shed
              and s.failures == 0 and s.requests + s.rejected == SERVE_N
              and (policy == "hopeless" or s.shed == 0)
              and s.batches == s.flush_capacity + s.flush_deadline
              + s.flush_drain + s.flush_retry
              and all(isinstance(h.exception(), (type(None), PlaneError))
                      for h in handles),
              f"11c {policy}: completed + failures + shed == requests "
              f"({s.as_dict()})")
        print(f"  11c overload, {cfg.overload_factor} x 11a's warm "
              f"{warm_rps:.3f} requests/s, max_queue_depth "
              f"{cfg.overload_queue_depth}, shed_policy {policy!r}: "
              f"{s.completed} completed == submit_many, {s.rejected} "
              f"rejected (Overloaded), {s.shed} shed (DeadlineShed), "
              f"{s.failures} failed; {s.batches} executions (capacity "
              f"{s.flush_capacity}, deadline {s.flush_deadline}, drain "
              f"{s.flush_drain}); deadline hit rate "
              f"{s.deadline_hit_rate:.3f}; {_latency_text(oeng)} ({smi})")
    del want, reqs, handles
    phase("serve 11c: overload", t0)

    # 11d. the distributed engine on one NCCL rank at 512^3 -----------------
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        shape = tuple(host["order"].shape)
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(os.path.join(
                                    tmp, "store_11d"), 1), rank=0,
                                world_size=1)
        try:
            mesh = make_dpc_mesh((1, 1, 1), device=dev)
            field = perlin_noise(shape, frequency=0.1, seed=SEED, device=dev)
            thr = np.array([quantile(field, qq) for qq in SWEEP_QS],
                           np.float32)
            base = dict(backend="distributed", mesh=mesh, grid_shape=shape,
                        connectivity=conn)
            dreqs = [TopologyRequest("ms", order=host["order"].to(dev),
                                     tag="ms", **base),
                     TopologyRequest("threshold_sweep", field=field,
                                     thresholds=thr, tag="sweep", **base)]
            deng = TopologyEngine(max_batch=cfg.max_batch, device=dev)
            sync()
            peak_gb(reset=True)
            _zero_fused_launches()
            got = deng.submit_batch(dreqs)
            sync()
            launches["11d"] = _fused_launches()
            peak = peak_gb()
            check(not on_card or launches["11d"] == {
                "manifold": 2, "cc": len(SWEEP_QS)},
                  f"11d: one batched call a bucket, one launch a slot "
                  f"({launches['11d']})")
            ds = deng.stats
            check(ds.batches == 2 and ds.padded_cells == ds.real_cells,
                  f"11d: two buckets, no dummy slot ({ds.as_dict()})")
            for g, r in zip(got, dreqs):
                _serve_same(g, submit(r), f"11d {r.tag}")
            for k in ("descending", "ascending", "segmentation"):
                check(torch.equal(getattr(got[0], k).cpu(), host[k]),
                      f"11d ms {k} == phase 4's pure ms query")
            del got
            if on_card:
                eng_ms = event_ms(lambda: deng.submit_batch(dreqs), 3)
                fac_ms = event_ms(lambda: [submit(r) for r in dreqs], 3)
                print(f"  11d one NCCL rank, {shape} (a 514^3 extended "
                      f"block): one submit_batch of an ms and a K = "
                      f"{len(SWEEP_QS)} sweep (buckets of 2 manifold and "
                      f"{len(SWEEP_QS)} cc slots) {eng_ms:.3f} ms; the "
                      f"facade's two sequential calls (9a's routes) "
                      f"{fac_ms:.3f} ms (warm, median of 3, CUDA events); "
                      f"peak device memory {peak:.3f} GB ({smi})")
            print(f"  11d: labels and stats == the facade's, ms == phase "
                  f"4's pure query; fused launches {launches['11d']}")
            del field, dreqs
        finally:
            dist.destroy_process_group()
        if on_card:
            torch.cuda.empty_cache()
        phase("serve 11d: distributed engine, one rank, NCCL, 512^3", t0)

        # 11e. eight gloo ranks sharing the card ---------------------------
        t0 = time.perf_counter()
        mp.spawn(_rank_11e, args=(os.path.join(tmp, "store_11e"), tmp,
                                  dev.type), nprocs=8, join=True)
        outs = []
        for rank in range(8):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        launches["11e"] = {k: sum(o["launches"][k] for o in outs)
                           for k in ("manifold", "cc")}
        if on_card:
            fused["11e"] = {k: (max(o["fused_err"][k] for o in outs), None)
                            for k in ("manifold", "cc")}
        check(not on_card or launches["11e"] == {"manifold": 8 * 16,
                                                 "cc": 8 * 16},
              f"11e: one launch a slot a rank ({launches['11e']})")
        print(f"  11e {RAGGED} over (2, 2, 2), connectivity 6 and 26, both "
              f"table modes: the sync engine == each rank's facade (labels "
              f"and stats), and the async engine (VirtualClock) at "
              f"connectivity 6, {MODES[0]}, where a table_max_iter=1 "
              f"request fails alone on every rank; the MonotonicClock guard "
              f"raises ValueError; sync fused launches {launches['11e']}; "
              f"ghost-masked kernel == plain on each rank's real and dummy "
              f"block, max err {fused.get('11e')}")
        phase("serve 11e: distributed engine, eight ranks, gloo", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, fused


def _serve_main(argv):
    """`repro_torch.launch.serve.main(argv)`, its printed lines echoed after
    it returns: (return value, printed text)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = serve.main(argv)
    text = out.getvalue()
    for line in text.splitlines():
        print(f"  {line[:400]}")
    return ret, text


def _json_after(text, prefix):
    """The JSON object that follows `prefix` on the one line starting so."""
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    check(len(lines) == 1, f"one {prefix!r} line in the launcher's output")
    return json.loads(lines[0][len(prefix):])


def lm_path(smi, dev, smoke=False):
    """Phase 12: LM serving, llama3.2-1b's `full_config()` in bf16 with
    weights drawn on the card from a seed.  12a the launcher's LM mode
    (`repro_torch.launch.serve.main`, a warm-up and LM_RUNS timed
    generations of LM_BATCH prompts of LM_PROMPT, LM_GEN greedy tokens),
    the flash_attention counts set to 0 just before and read just after;
    12b one profiled prefill and one profiled decode step on the same
    weights and prompts, launches counted apart, and layer 0's kernel
    launch at the served shape held to the plain version; 12c at batch 1 x
    LM_CHECK_PROMPT, every layer's kernel launch on the served model's own
    inputs held to the plain version (the gate), then, as a secondary
    check, the whole model with the kernel against the same model with
    attention through the plain version, both against the fp32 model.
    `smoke` runs the smoke config at small sizes (on `dev` = cpu: a
    rehearsal, no launch counted, nothing held to the kernel).  Returns
    (the kernel's launches by sub-phase, max abs error of the launches
    held to plain)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_mod, ref
    from repro_torch.models import lm
    from repro_torch.nn.core import rms_norm

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    mod = configs.get(LM_ARCH)
    cfg = mod.smoke_config() if smoke else mod.full_config()
    batch, prompt, gen, check_prompt = ((2, 64, 4, 32) if smoke else
                                        (LM_BATCH, LM_PROMPT, LM_GEN,
                                         LM_CHECK_PROMPT))
    key = flash_mod.route(cfg.compute_dtype, cfg.head_dim)
    print(f"  {cfg.name}: {cfg.n_params()} parameters, "
          f"{cfg.n_params() * cfg.param_dtype.itemsize / 1e9:.3f} GB in "
          f"{cfg.param_dtype}; KV cache of {batch} x {prompt + gen} "
          f"positions {2 * cfg.n_layers * batch * cfg.n_kv_heads * (prompt + gen) * cfg.head_dim * cfg.compute_dtype.itemsize / 1e9:.3f} GB")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def zero():
        for k in flash_mod.launches:
            flash_mod.launches[k] = 0

    # 12a. the launcher, counts set to 0 just before and read just after --
    argv = ["--arch", LM_ARCH, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--seed", str(LM_SEED),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    zero()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tps, text = _serve_main(argv)
    sync()
    launches = {"launcher": dict(flash_mod.launches)}
    stats = _json_after(text, "[serve] lm stats:")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    want = {k: cfg.n_layers * stats["prefills"] * (k == key) * on_card
            for k in flash_mod.launches}
    print(f"  12a launcher: flash_attention launches {launches['launcher']} "
          f"for {stats['prefills']} prefills of {cfg.n_layers} layers")
    check(launches["launcher"] == want, f"the launcher's prefills launched "
          f"the {key} kernel once a layer and nothing else: "
          f"{launches['launcher']} (want {want})")
    cont = torch.tensor(stats["continuation"])
    check(tuple(cont.shape) == (batch, gen) and bool((cont >= 0).all())
          and bool((cont < cfg.vocab).all()), "the continuation is "
          f"{batch} x {gen} ids in [0, vocab)")
    numbers = {"prefill_ms": stats["prefill_ms"],
               "prefill_ms_median": statistics.median(stats["prefill_ms"]),
               "decode_ms_per_token": stats["decode_ms_per_step"],
               "decode_ms_per_token_median": statistics.median(
                   stats["decode_ms_per_step"]),
               "tokens_per_s": tps, "peak_GB": peak}
    print(f"  12a {cfg.name} {str(cfg.compute_dtype)[6:]} serving, batch {batch} x prompt {prompt}, "
          f"{gen} greedy tokens: prefill {numbers['prefill_ms_median']:.3f} "
          f"ms (median of {len(stats['prefill_ms'])}: {stats['prefill_ms']}),"
          f" decode {numbers['decode_ms_per_token_median']:.3f} ms a token "
          f"step ({stats['decode_ms_per_step']}), {tps:.1f} tokens/s, peak "
          f"device memory {peak} GB ({smi})")
    phase("LM serving 12a: the launcher", t0)

    # 12b. one prefill and one decode step, counted apart; layer 0 --------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = lm.init_params(g, cfg)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=dev)
    zero()
    out = {}

    def run_prefill():
        out["prefill"] = lm.prefill(params, prompts, cfg,
                                    max_len=prompt + gen)

    if on_card:
        profile(run_prefill, f"12b one prefill, batch {batch} x {prompt}",
                top=8)
    else:
        run_prefill()
    logits, cache = out.pop("prefill")
    sync()
    launches["prefill"] = dict(flash_mod.launches)
    nxt = logits.argmax(-1)[:, None]
    check(torch.equal(nxt[:, 0].cpu(), cont[:, 0]), "the prefill's greedy "
          "tokens == the launcher's first tokens (same seed)")
    zero()
    if on_card:
        rows = profile(lambda: lm.decode_step(params, cache, nxt, cfg),
                       f"12b one decode step, batch {batch}, cache "
                       f"{prompt + gen}")
        busy = sum(r[1] for r in rows)
        numbers["decode_profile_busy_ms"] = busy
    else:
        lm.decode_step(params, cache, nxt, cfg)
    sync()
    launches["decode_step"] = dict(flash_mod.launches)
    check(launches["prefill"] == {k: cfg.n_layers * (k == key) * on_card
                                  for k in flash_mod.launches}
          and not any(launches["decode_step"].values()),
          f"a prefill launches the kernel once a layer, a decode step never: "
          f"{launches['prefill']}, {launches['decode_step']}")
    print(f"  12b flash_attention launches: prefill {launches['prefill']}, "
          f"decode step {launches['decode_step']}")
    del cache, logits
    err = None
    if on_card:
        lp = params["layers"][0]
        x = params["embed"][prompts]
        pos = torch.arange(prompt, device=dev).expand(batch, prompt)
        q, k, v = lm.attention_inputs(rms_norm(x, lp["ln1"]), lp, cfg, pos)
        del x
        got = flash_mod.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
        want = ref.flash_attention_kernel_ref(q, k, v, causal=True,
                                              block_k=512)
        sync()
        share, at = limit_share(got, want, ATTN_BF16_FULL)
        err = float((got.float() - want.float()).abs().max())
        check(share <= 1 and not torch.isnan(got).any(),
              f"layer 0's flash_attention launch at {tuple(q.shape)} == "
              f"plain within rtol {ATTN_BF16_FULL[0]}, atol "
              f"{ATTN_BF16_FULL[1]} (worst element at {share} of its limit, "
              f"{at}; max abs err {err})")
        print(f"  12b layer 0 at the served shape q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}: kernel == plain within rtol "
              f"{ATTN_BF16_FULL[0]} / atol {ATTN_BF16_FULL[1]}, worst "
              f"element at {share:.4f} of its limit, max abs err {err}")
        del q, k, v, got, want
    del prompts
    phase("LM serving 12b: prefill, decode step, layer 0", t0)

    # 12c. every layer's launch against plain on the model's own inputs --
    t0 = time.perf_counter()
    tok = torch.randint(0, cfg.vocab, (1, check_prompt), generator=g,
                        device=dev)
    if on_card:
        x = lm._embed(params["embed"], tok, cfg.compute_dtype)
        pos = torch.arange(check_prompt, device=dev)[None]
        shares = []
        for i, lp in enumerate(params["layers"]):
            q, k, v = lm.attention_inputs(rms_norm(x, lp["ln1"]), lp, cfg,
                                          pos)
            got = flash_mod.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=True)
            want = ref.flash_attention_kernel_ref(q, k, v, causal=True,
                                                  block_k=512)
            share, at = limit_share(got, want, ATTN_BF16_FULL)
            e = float((got.float() - want.float()).abs().max())
            err = max(err, e)
            check(share <= 1 and not torch.isnan(got).any(),
                  f"layer {i}'s flash_attention launch at {tuple(q.shape)} "
                  f"== plain within rtol {ATTN_BF16_FULL[0]}, atol "
                  f"{ATTN_BF16_FULL[1]} (worst element at {share} of its "
                  f"limit, {at}; max abs err {e})")
            shares.append(round(share, 4))
            x = lm._layer(x, lp, cfg, pos)[0]   # the served layer, kernel
        del x, q, k, v, got, want
        print(f"  12c every layer's launch at batch 1 x {check_prompt} "
              f"on the served model's inputs: kernel == plain within rtol "
              f"{ATTN_BF16_FULL[0]} / atol {ATTN_BF16_FULL[1]}; worst "
              f"element's share of its limit by layer {shares}; max abs err "
              f"{err}")
        numbers["layer_limit_shares"] = shares

    # the whole model, kernel against plain, both against fp32 (secondary:
    # with random weights attention is near uniform and barely moves the
    # logits, so this bounds the damage end to end but is not the gate)
    steps = 8
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items() if k != "layers"}
    p32["layers"] = [{k: v.float() for k, v in lp.items()}
                     for lp in params["layers"]]
    l32, _ = lm.prefill(p32, tok, cfg32, impl="plain")
    del p32

    def greedy(impl):
        logits, cache = lm.prefill(params, tok, cfg, max_len=check_prompt
                                   + steps, impl=impl)
        out = [logits.float()]
        for _ in range(steps - 1):
            logits, cache = lm.decode_step(params, cache,
                                           logits.argmax(-1)[:, None], cfg)
            out.append(logits.float())
        return torch.cat(out)                    # (steps, V)

    kern, plain = greedy("auto"), greedy("plain")
    sync()
    e_plain = float((plain[0] - l32[0]).abs().max())
    e_kern = float((kern[0] - l32[0]).abs().max())
    diff = float((kern[0] - plain[0]).abs().max())
    # the plain bf16 model's distance from the fp32 one is bf16's own
    # rounding on this input; two bf16 paths that each round as much may
    # differ by up to twice that, and a kernel that dropped or misweighted
    # keys would move the logits by more
    tol = 2 * e_plain
    print(f"  12c batch 1 x prompt {check_prompt}, last-token logits: kernel "
          f"vs plain max abs diff {diff}; against the fp32 model (same "
          f"weights, plain attention): plain {e_plain}, kernel {e_kern}; "
          f"tolerance 2 x plain's = {tol}")
    check(diff <= tol, f"the bf16 model with the kernel stays within twice "
          f"the plain bf16 model's own distance from fp32 of it: {diff} <= "
          f"{tol}")
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    compared = 0
    for i in range(steps):
        same = bool(kern[i].argmax() == plain[i].argmax())
        if not same:
            check(float(margin[i]) <= tol, f"greedy token {i} differs where "
                  f"the plain path's top-2 margin {float(margin[i])} > {tol}")
            break                       # the two continuations part here
        compared += 1
    print(f"  12c greedy tokens: kernel == plain for the first {compared} of "
          f"{steps} steps (top-2 margins {margin.tolist()}); tokens are "
          f"required equal where the margin exceeds {tol}")
    numbers.update(logits_diff=diff, logits_vs_fp32_plain=e_plain,
                   logits_vs_fp32_kernel=e_kern, greedy_equal_steps=compared)
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    del params, kern, plain, l32
    phase("LM serving 12c: every layer's launch, whole model", t0)
    return launches, err


def bst_path(smi, dev, smoke=False):
    """Phase 13: BST serving, `configs/bst.py`'s `full_config()` in fp32,
    weights drawn on the card: `forward` at serve_p99 and serve_bulk and
    `retrieval_step` at retrieval_cand, batches from `data/recsys.py` (seed
    0).  Each forward's segment_bag counts are set to 0 just before and
    read just after (2 a forward, 0 in retrieval); its bags and logits are
    held to the model with the bags' plain version, its retrieval ids to
    an independent top-k under JAX's tie rule.  Warm medians of 3, peak
    device memory.  `smoke` runs the smoke config (on a cpu `dev`: a
    rehearsal).  Returns (launches by shape, max abs error of the bags)."""
    import torch
    from repro_torch import configs
    from repro_torch.data import recsys
    from repro_torch.kernels import segment_bag as bag_mod
    from repro_torch.models import bst

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    mod = configs.get("bst")
    cfg = mod.smoke_config() if smoke else mod.full_config()
    shapes = mod.SMOKE_SHAPES if smoke else mod.SHAPES
    params = bst.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"  {cfg.name} tables (fp32): items {tuple(params['item_embed'].shape)}"
          f", profile {tuple(params['profile_embed'].shape)}, multihot "
          f"{tuple(params['multihot_embed'].shape)}; "
          f"{sum(t.numel() for t in params.values() if torch.is_tensor(t)) * 4 / 1e9:.3f} GB")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        return event_ms(fn, 3) if on_card else None

    launches, err, numbers = {}, 0.0, {}
    for shape in ("serve_p99", "serve_bulk"):
        n = shapes[shape]["batch"]
        b = recsys.to_tensors(recsys.bst_batch(cfg, n, seed=0), dev)
        for key in bag_mod.launches:
            bag_mod.launches[key] = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        logits = bst.forward(params, b, cfg)
        sync()
        launches[shape] = dict(bag_mod.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        check(launches[shape] == {"float32": 2 * on_card, "bfloat16": 0},
              f"BST forward {shape} launched segment_bag twice (f32): "
              f"{launches[shape]}")
        # the profile half of the user tower: the gathers and the two bags
        bags = bst.user_tower(params, b, cfg)[1]
        bags_plain = bst.user_tower(params, b, cfg, impl="plain")[1]
        plain = bst.forward(params, b, cfg, impl="plain")
        sync()
        e_bag = float((bags - bags_plain).abs().max())
        e_log = float((logits - plain).abs().max())
        err = max(err, e_bag)
        check(torch.allclose(bags, bags_plain, rtol=TOL["float32"]["bag"],
                             atol=TOL["float32"]["bag"])
              and torch.allclose(logits, plain, rtol=BST_LOGIT_TOL[0],
                                 atol=BST_LOGIT_TOL[1])
              and bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (n,),
              f"BST {shape}: bags within 1e-5 and logits within rtol "
              f"{BST_LOGIT_TOL[0]} / atol {BST_LOGIT_TOL[1]} of the plain "
              f"bags' model (bags {e_bag}, logits {e_log})")
        ms = timed(lambda: bst.forward(params, b, cfg))
        plain_ms = timed(lambda: bst.forward(params, b, cfg, impl="plain"))
        numbers[shape] = {"batch": n, "ms": ms, "plain_bags_ms": plain_ms,
                          "peak_GB": peak, "bag_err": e_bag,
                          "logit_err": e_log}
        print(f"  13 forward {shape} (batch {n}): {ms} ms (warm, median of "
              f"3), with the bags' plain version {plain_ms} ms; peak "
              f"{peak} GB; segment_bag launches {launches[shape]}; bags "
              f"max abs err {e_bag}, logits {e_log} ({smi})")
        del b, logits, plain, bags, bags_plain

    shape = shapes["retrieval_cand"]
    r = recsys.to_tensors(recsys.retrieval_batch(
        cfg, shape["batch"], shape["n_candidates"], seed=0), dev)
    for key in bag_mod.launches:
        bag_mod.launches[key] = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    vals, ids = bst.retrieval_step(params, r, cfg)
    sync()
    launches["retrieval_cand"] = dict(bag_mod.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    check(not any(launches["retrieval_cand"].values()),
          "retrieval launches no bag kernel (it reads the sequence tower "
          "only)")
    # (1) the ranking: the card's fp32 scores of the same pooled vector
    # (`@` on the card), ranked on the host by (-score, index), JAX's
    # lax.top_k order; ids and scores must equal retrieval_step's exactly
    top = vals.shape[1]
    cand = r["candidates"][0].long()
    seq_r = bst.user_tower(params, r, cfg)[0].reshape(
        1, cfg.seq_len + 1, cfg.embed_dim)
    items = params["item_embed"][cand]
    s_np = (items @ seq_r.mean(1)[0]).cpu().numpy()
    order = np.lexsort((np.arange(s_np.size), -s_np))[:top]
    check(np.array_equal(ids[0].cpu().numpy(),
                         r["candidates"][0].cpu().numpy()[order])
          and np.array_equal(vals[0].cpu().numpy(), s_np[order]),
          "retrieval ids == the host's (score desc, index asc) top-k of the "
          "same scores")
    # (2) the scores: the mean over the pooled sequence and the dot with
    # the candidates again on the host in float64, from the same tower
    # output; each returned score within 1e-5 of the largest |item| . |u|
    # of its float64 value (fp32 rounds a mean of 21 and a dot of 32 to a
    # few ulps of that), and the k-th score within that of float64's k-th
    # best, so no candidate that scores higher by more was left out
    u64 = seq_r.cpu().double().mean(1)[0]
    items64 = items.cpu().double()
    s64 = (items64 @ u64).numpy()
    score_tol = 1e-5 * float((items64.abs() @ u64.abs()).max())
    v_np = vals[0].cpu().double().numpy()
    e_score = float(np.abs(v_np - s64[order]).max())
    kth = float(np.sort(s64)[::-1][top - 1])
    check(e_score <= score_tol and abs(v_np[-1] - kth) <= score_tol,
          f"retrieval scores within {score_tol} of float64 (max err "
          f"{e_score}); the k-th {v_np[-1]} against float64's k-th best "
          f"{kth}")
    del items, items64, seq_r
    n_dup = int(cand.numel() - torch.unique(cand).numel())
    ties = int((vals[0, 1:] == vals[0, :-1]).sum())
    ms = timed(lambda: bst.retrieval_step(params, r, cfg))
    numbers["retrieval_cand"] = {"candidates": int(cand.numel()), "ms": ms,
                                 "peak_GB": peak, "duplicates": n_dup,
                                 "ties_in_top_k": ties,
                                 "score_err_vs_float64": e_score,
                                 "score_tol": score_tol}
    print(f"  13 retrieval_step {shape['batch']} x {shape['n_candidates']}, "
          f"top {vals.shape[1]}: {ms} ms (warm, median of 3); peak {peak} "
          f"GB; {n_dup} duplicate candidates, {ties} equal neighbours in "
          f"the top k; scores within {e_score} of float64 (limit "
          f"{score_tol}); segment_bag launches {launches['retrieval_cand']} "
          f"({smi})")
    del params, r, vals, ids
    phase("BST serving", t0)
    return launches, err


def launcher_topology(dev):
    """The launcher's topology mode at its smoke config, on the card and on
    the CPU: the engine stats printed must be equal (the CPU tests hold the
    CPU's to the JAX package's launcher)."""
    t0 = time.perf_counter()
    argv = ["--topology", "--smoke", "--requests", "6", "--repeat", "2"]
    rate, text = _serve_main(argv + ["--device", str(dev)])
    _, cpu_text = _serve_main(argv + ["--device", "cpu"])
    prefix = "[serve-topology] engine stats:"
    got, want = _json_after(text, prefix), _json_after(cpu_text, prefix)
    check(got == want and rate > 0, f"the launcher's topology stats on "
          f"{dev} == on the CPU: {got} vs {want}")
    phase("launcher: topology mode", t0)


def _moe_check(params, tokens, cfg, dev, label):
    """The MoE FFN of layer 0 on its own input: one prompt (1, S) through
    layer 0's attention, the residual's ln2 norm = the FFN's T = S tokens.
    (1) the router's top-k on the card == a host recount (a stable
    descending sort of the card's fp32 probabilities, lowest expert first
    on ties), and the dispatch table and weights == a host recount of
    stable capacity positions; (2) for MOE_SAMPLE tokens, the MoE output
    (bf16) against a per-expert loop in fp32 over each token's kept
    experts plus the shared experts, within MOE_BF16_TOL of the token's
    largest |output| (in fp32 configs MOE_F32_TOL).  Returns numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import lm
    from repro_torch.nn.core import rms_norm

    lp = params["layers"][0]
    s = tokens.shape[1]
    with torch.no_grad():
        x = lm._embed(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(s, device=dev)[None]
        x = x + lm._attention(rms_norm(x, lp["ln1"]), lp, cfg, pos)[0]
        xn = rms_norm(x, lp["ln2"])[0]                         # (T, D)
        probs, topi, topv = lm._route(xn, lp, cfg)
        mcfg = cfg.moe
        E, k, C = mcfg.n_experts, mcfg.top_k, lm.capacity(s, mcfg)
        table, wtab, _ = lm._dispatch_tables(topi, topv, s, E, C)
        y = lm._moe_ffn(xn, lp, cfg)[0]
    # (1) the host recount
    p = probs.cpu().numpy()
    host_topi = np.argsort(-p, axis=1, kind="stable")[:, :k]
    check(np.array_equal(host_topi, topi.cpu().numpy()),
          f"{label}: the card's top-{k} == a host stable sort of its "
          "probabilities")
    flat = host_topi.reshape(-1)
    w = topv.cpu().numpy().reshape(-1)
    order = np.argsort(flat, kind="stable")
    host_table = np.full(E * C, s, np.int32)
    host_w = np.zeros(E * C, np.float32)
    filled = np.zeros(E, np.int64)
    for slot in order:                 # slots by expert, then token order
        e = flat[slot]
        if filled[e] < C:
            host_table[e * C + filled[e]] = slot // k
            host_w[e * C + filled[e]] = w[slot]
        filled[e] += 1
    check(np.array_equal(host_table, table.cpu().numpy())
          and np.array_equal(host_w, wtab.cpu().numpy()),
          f"{label}: the dispatch table and weights == a host recount of "
          f"stable capacity positions (C = {C})")
    kept = int((host_table < s).sum())
    dropped = int(s * k - kept)
    # (2) sampled tokens in fp32 against the card's output
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = min(MOE_SAMPLE, s)
    sample = torch.randperm(s, generator=gen)[:n].numpy()
    at = {int(t): i for i, t in enumerate(sample)}
    x32 = xn[torch.from_numpy(sample).to(dev)].float()
    want = torch.zeros_like(x32)
    slots = np.nonzero(np.isin(host_table, sample))[0]
    for e in np.unique(slots // C):
        es = slots[slots // C == e]
        rows = torch.tensor([at[int(t)] for t in host_table[es]], device=dev)
        wts = torch.from_numpy(host_w[es]).to(dev)[:, None]
        h = (F.silu(x32[rows] @ lp["we_gate"][e].float())
             * (x32[rows] @ lp["we_up"][e].float()))
        want.index_add_(0, rows, wts * (h @ lp["we_down"][e].float()))
    hs = (F.silu(x32 @ lp["ws_gate"].float())
          * (x32 @ lp["ws_up"].float()))
    want += hs @ lp["ws_down"].float()
    got = y[torch.from_numpy(sample).to(dev)].float()
    tol = MOE_BF16_TOL if cfg.compute_dtype == torch.bfloat16 else MOE_F32_TOL
    share = float(((got - want).abs().amax(1)
                   / (tol * want.abs().amax(1))).max())
    err = float((got - want).abs().max())
    check(share <= 1 and bool(torch.isfinite(got).all()),
          f"{label}: {n} sampled tokens' MoE output == a per-expert fp32 "
          f"loop within {tol} of each token's largest |output| (worst at "
          f"{share} of that; max abs err {err})")
    print(f"  {label} MoE check, layer 0, one prompt of {s} (C = {C}): "
          f"top-{k} and dispatch == host recount ({kept} slots kept, "
          f"{dropped} dropped); {n} sampled tokens within {tol} of their "
          f"largest |output|, worst at {share:.4f} of it, max abs err {err}")
    return {"capacity": C, "kept": kept, "dropped": dropped,
            "sample_share": share, "sample_err": err}


def _attention_vs_plain(params, tokens, cfg, dev, label):
    """Layer 0's attention launch on its own q, k, v at the served shape
    against the plain version, within phase 7's bf16 limit (ATTN_BF16_FULL)
    or the fp32 one; returns the max abs error (None off the card)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod, ref
    from repro_torch.models import lm
    from repro_torch.nn.core import rms_norm

    if dev.type != "cuda":
        return None
    lp = params["layers"][0]
    b, s = tokens.shape
    with torch.no_grad():
        x = lm._embed(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(s, device=dev).expand(b, s)
        q, k, v = lm.attention_inputs(rms_norm(x, lp["ln1"]), lp, cfg, pos)
        del x
        got = flash_mod.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
        want = ref.flash_attention_kernel_ref(q, k, v, causal=True,
                                              block_k=512)
    tol = (ATTN_BF16_FULL if cfg.compute_dtype == torch.bfloat16
           else TOL["float32"]["attn"])
    share, at = limit_share(got, want, tol)
    err = float((got.float() - want.float()).abs().max())
    check(share <= 1 and not torch.isnan(got).any(),
          f"{label}: layer 0's flash_attention launch at {tuple(q.shape)} "
          f"== plain within {tol} (worst element at {share} of its limit, "
          f"{at}; max abs err {err})")
    print(f"  {label} layer 0 at q {tuple(q.shape)}, k/v {tuple(k.shape)}: "
          f"kernel == plain within {tol}, worst element at {share:.4f} of "
          f"its limit, max abs err {err}")
    return err


def moe_path(smi, dev, smoke=False):
    """Phase 14: MoE serving.  14a deepseek-moe-16b's `full_config()` in
    bf16 (weights drawn on the card from seed MOE_SEED) through the
    launcher's LM mode (MOE_BATCH prompts of MOE_PROMPT, MOE_GEN greedy
    tokens), the flash_attention counts set to 0 just before and read just
    after; then one prefill and one decode step counted apart, layer 0's
    attention launch at the served shape held to plain, and `_moe_check`
    on layer 0's own input of one prompt.  14b kimi-k2-1t-a32b at full
    width, its 61 layers cut to KIMI_LAYERS: a 1 x KIMI_PROMPT prefill and
    KIMI_STEPS decode steps, counted and timed, the layer's attention
    launch held to plain, `_moe_check`.  `smoke` runs the smoke configs at
    small sizes (on a cpu `dev`: a rehearsal).  Returns (launches by
    sub-phase, max abs error of the launches held to plain)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import lm

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def zero():
        for key in flash_mod.launches:
            flash_mod.launches[key] = 0

    def gb(cfg):
        return cfg.n_params() * cfg.param_dtype.itemsize / 1e9

    # 14a. deepseek-moe-16b through the launcher --------------------------------
    mod = configs.get(MOE_ARCH)
    cfg = mod.smoke_config() if smoke else mod.full_config()
    batch, prompt, gen = (2, 64, 4) if smoke else (MOE_BATCH, MOE_PROMPT,
                                                   MOE_GEN)
    key = flash_mod.route(cfg.compute_dtype, cfg.head_dim)
    print(f"  14a {cfg.name}: {cfg.n_params()} parameters "
          f"({cfg.n_active_params()} active), {gb(cfg):.3f} GB in "
          f"{cfg.param_dtype}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared; capacity "
          f"{lm.capacity(batch * prompt, cfg.moe)} a prefill, "
          f"{lm.capacity(batch, cfg.moe)} a decode step")
    argv = ["--arch", MOE_ARCH, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--seed", str(MOE_SEED),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    zero()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tps, text = _serve_main(argv)
    sync()
    launches = {"14a_launcher": dict(flash_mod.launches)}
    stats = _json_after(text, "[serve] lm stats:")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    want = {k: cfg.n_layers * stats["prefills"] * (k == key) * on_card
            for k in flash_mod.launches}
    check(launches["14a_launcher"] == want, f"14a: the launcher's prefills "
          f"launched the {key} kernel once a layer and nothing else: "
          f"{launches['14a_launcher']} (want {want})")
    cont = torch.tensor(stats["continuation"])
    check(tuple(cont.shape) == (batch, gen) and bool((cont >= 0).all())
          and bool((cont < cfg.vocab).all()), "14a: the continuation is "
          f"{batch} x {gen} ids in [0, vocab)")
    pre = statistics.median(stats["prefill_ms"])
    dec = statistics.median(stats["decode_ms_per_step"])
    print(f"  14a {cfg.name} {str(cfg.compute_dtype)[6:]} serving, batch "
          f"{batch} x prompt {prompt}, "
          f"{gen} greedy tokens: prefill {pre:.3f} ms (median of "
          f"{len(stats['prefill_ms'])}: {stats['prefill_ms']}), decode "
          f"{dec:.3f} ms a token step ({stats['decode_ms_per_step']}), "
          f"{tps:.1f} tokens/s, peak device memory {peak} GB; launches "
          f"{launches['14a_launcher']} ({smi})")
    phase("MoE serving 14a: the launcher", t0)

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(MOE_SEED)
    params = lm.init_params(g, cfg)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=dev)
    zero()
    out = {}

    def run_prefill():
        out["prefill"] = lm.prefill(params, prompts, cfg, max_len=prompt + 1)

    with torch.no_grad():
        if on_card:
            profile(run_prefill, f"14a one prefill, batch {batch} x {prompt}",
                    top=8)
        else:
            run_prefill()
        logits, cache = out.pop("prefill")
        sync()
        launches["14a_prefill"] = dict(flash_mod.launches)
        nxt = logits.argmax(-1)[:, None]
        check(torch.equal(nxt[:, 0].cpu(), cont[:, 0]), "14a: the prefill's "
              "greedy tokens == the launcher's first tokens (same seed)")
        zero()
        if on_card:
            profile(lambda: lm.decode_step(params, cache, nxt, cfg),
                    f"14a one decode step, batch {batch}", top=8)
        else:
            lm.decode_step(params, cache, nxt, cfg)
        sync()
    launches["14a_decode_step"] = dict(flash_mod.launches)
    check(launches["14a_prefill"] == {k: cfg.n_layers * (k == key) * on_card
                                      for k in flash_mod.launches}
          and not any(launches["14a_decode_step"].values()),
          f"14a: a prefill launches the kernel once a layer, a decode step "
          f"never: {launches['14a_prefill']}, {launches['14a_decode_step']}")
    del cache, logits
    err = _attention_vs_plain(params, prompts, cfg, dev, "14a") or 0.0
    numbers = {"14a": {"prefill_ms": pre, "decode_ms_per_step": dec,
                       "tokens_per_s": tps, "peak_GB": peak,
                       **_moe_check(params, prompts[:1], cfg, dev, "14a")}}
    del params, prompts
    if on_card:
        torch.cuda.empty_cache()
    phase("MoE serving 14a: prefill, decode step, layer 0, MoE check", t0)

    # 14b. kimi-k2 at full width, depth cut -----------------------------------
    t0 = time.perf_counter()
    mod = configs.get(KIMI_ARCH)
    cfg = dataclasses.replace(mod.smoke_config() if smoke
                              else mod.full_config(), n_layers=KIMI_LAYERS)
    prompt, steps = (48, 2) if smoke else (KIMI_PROMPT, KIMI_STEPS)
    key = flash_mod.route(cfg.compute_dtype, cfg.head_dim)
    print(f"  14b {cfg.name}, {KIMI_LAYERS} of 61 layers: {cfg.n_params()} "
          f"parameters, {gb(cfg):.3f} GB in {cfg.param_dtype}; "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, GQA "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head dim {cfg.head_dim} "
          f"({key} kernel)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(MOE_SEED)
    params = lm.init_params(g, cfg)
    tok = torch.randint(0, cfg.vocab, (1, prompt), generator=g, device=dev)
    out = {}

    def run_prefill():
        out["prefill"] = lm.prefill(params, tok, cfg, max_len=prompt + steps)

    def run_decode():
        logits, cache = out["prefill"]
        for _ in range(steps):
            logits, cache = lm.decode_step(params, cache,
                                           logits.argmax(-1)[:, None], cfg)
        out["decode"] = logits

    with torch.no_grad():
        run_prefill()                   # warm-up of both, at their shapes
        run_decode()
        zero()
        pre = event_ms(run_prefill, 1) if on_card else run_prefill()
        sync()
        launches["14b_prefill"] = dict(flash_mod.launches)
        zero()
        dec = event_ms(run_decode, 1) if on_card else run_decode()
        sync()
    launches["14b_decode"] = dict(flash_mod.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    check(launches["14b_prefill"] == {k: KIMI_LAYERS * (k == key) * on_card
                                      for k in flash_mod.launches}
          and not any(launches["14b_decode"].values())
          and bool(torch.isfinite(out["decode"].float()).all()),
          f"14b: the prefill launches {key} once a layer, decode never, "
          f"logits finite: {launches['14b_prefill']}, "
          f"{launches['14b_decode']}")
    del out
    dec = dec / steps if on_card else None
    print(f"  14b {cfg.name} ({KIMI_LAYERS} layer) "
          f"{str(cfg.compute_dtype)[6:]}, 1 x {prompt}: "
          f"prefill {pre} ms, decode {dec} ms a step ({steps} steps), peak "
          f"device memory {peak} GB; launches {launches['14b_prefill']} / "
          f"{launches['14b_decode']} ({smi})")
    e = _attention_vs_plain(params, tok, cfg, dev, "14b")
    err = max(err, e or 0.0)
    numbers["14b"] = {"prefill_ms": pre, "decode_ms_per_step": dec,
                      "peak_GB": peak,
                      **_moe_check(params, tok, cfg, dev, "14b")}
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    del params, tok
    if on_card:
        torch.cuda.empty_cache()
    phase("MoE serving 14b: kimi-k2, one layer at full width", t0)
    return launches, err


def _grad_check(label, got, want, tol):
    """Each of (dq, dk, dv) within `tol` of its tensor's largest |want|;
    returns the worst share of that limit."""
    import torch
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        lim = tol * float(w.float().abs().max())
        share = float((g.float() - w.float()).abs().max()) / lim
        worst = max(worst, share)
        check(share <= 1 and bool(torch.isfinite(g.float()).all()),
              f"{label} {name} within {tol} of its largest |grad| (worst at "
              f"{share} of that)")
    return worst


def gradient_checks(smi, dev, smoke=False):
    """Phase 15a: the kernels' gradients.  Attention at llama3.2-1b's layer
    (1 x 32 heads, 8 kv heads, ATTN_GRAD_S, D 64, causal), bf16 and fp32:
    dq, dk, dv through `ops.flash_attention`'s autograd Function (the
    kernel's forward, `ops.attention_backward`) against autograd through
    the plain version, within ATTN_GRAD_TOL of each tensor's largest
    |grad|; the bag's table gradient at BST's serve_bulk ids (one call a
    field, f32) against autograd through the plain version, within
    BAG_GRAD_TOL.  Times of forward + backward, kernel path and plain.
    These launches compare and are not counted.  Returns numbers."""
    import torch
    from repro_torch import configs
    from repro_torch.data import recsys
    from repro_torch.kernels import ops, ref

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    impl = "kernel" if on_card else "auto"
    s = 64 if smoke else ATTN_GRAD_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    numbers = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, ATTN_H, s, ATTN_D, generator=gen, device=dev,
                        dtype=dtype)
        k, v = (torch.randn(1, ATTN_HKV, s, ATTN_D, generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        do = torch.randn(1, ATTN_H, s, ATTN_D, generator=gen, device=dev,
                         dtype=dtype)

        def grads(fn):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            fn(*leaves).backward(do)
            return [t.grad for t in leaves]

        def kernel_path(*a):
            return ops.flash_attention(*a, causal=True, impl=impl,
                                       check_tiles=False)

        def plain_path(*a):
            return ref.flash_attention_kernel_ref(*a, causal=True,
                                                  block_k=512)

        got, want = grads(kernel_path), grads(plain_path)
        name = str(dtype).removeprefix("torch.")
        tol = ATTN_GRAD_TOL[name]
        share = _grad_check(f"15a attention {name}", got, want, tol)
        del got, want
        ms = event_ms(lambda: grads(kernel_path), 3) if on_card else None
        plain_ms = event_ms(lambda: grads(plain_path), 3) if on_card else None
        numbers[f"attention_{name}"] = {"share": share, "ms": ms,
                                        "plain_ms": plain_ms}
        print(f"  15a attention gradient {name}, q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}, causal: dq, dk, dv through the kernel's "
              f"Function == autograd through plain within {tol} of each "
              f"largest |grad| (worst at {share:.4f} of it); forward + "
              f"backward {ms} ms, plain {plain_ms} ms ({smi})")
        del q, k, v, do
    cfg = configs.get("bst").smoke_config() if smoke else \
        configs.get("bst").full_config()
    n = 64 if smoke else BAG_B
    b = recsys.to_tensors(recsys.bst_batch(cfg, n, seed=0), dev)
    v = cfg.n_multihot_fields * cfg.multihot_vocab
    table = torch.randn(v, cfg.embed_dim, generator=gen, device=dev)
    worst = 0.0
    for f in range(cfg.n_multihot_fields):
        ids = b["multihot_ids"][:, f]
        ids = torch.where(ids >= 0, ids + f * cfg.multihot_vocab, -1)
        dout = torch.randn(n, cfg.embed_dim, generator=gen, device=dev)
        t1, t2 = (table.clone().requires_grad_() for _ in range(2))
        ops.embedding_bag(t1, ids, impl=impl).backward(dout)
        ref.segment_bag_ref(t2, ids).backward(dout)
        lim = BAG_GRAD_TOL * float(t2.grad.abs().max())
        share = float((t1.grad - t2.grad).abs().max()) / lim
        worst = max(worst, share)
        check(share <= 1, f"15a bag gradient field {f} within {BAG_GRAD_TOL} "
              f"of its largest |grad| (worst at {share} of that)")
    numbers["bag_float32"] = {"share": worst}
    print(f"  15a bag gradient f32 at BST's {n} x {cfg.multihot_len} ids a "
          f"field, table {tuple(table.shape)}: the Function's index_add == "
          f"autograd through plain within {BAG_GRAD_TOL} of the largest "
          f"|grad| (worst at {worst:.4f} of it)")
    del table, b
    phase("training 15a: the kernels' gradients", t0)
    return numbers


def _train_main(argv, launches):
    """`repro_torch.launch.train.main(argv)` with each train step timed
    (synchronised) and its flash_attention launches and loss recorded, the
    printed lines echoed after it returns; restores are compared with the
    checkpoint's arrays on disk bit for bit.  Returns (eval loss, report,
    {"step_s", "loss", "launches", "restored"})."""
    import contextlib
    import io
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _host
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map_with_names

    rec = {"step_s": [], "loss": [], "launches": [], "restored": []}
    make_step, manager = train.make_step, train.CheckpointManager

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def timed_make_step(cfg, opt, dev, mesh=None):
        step = make_step(cfg, opt, dev, mesh)

        def run(state, batch):
            sync()
            before = sum(launches.values())
            t = time.perf_counter()
            state, metrics = step(state, batch)
            sync()
            rec["step_s"].append(time.perf_counter() - t)
            rec["launches"].append(sum(launches.values()) - before)
            rec["loss"].append(float(metrics["loss"]))
            return state, metrics
        return run

    class Checked(CheckpointManager):
        def restore(self, template, step=None):
            tree, manifest = super().restore(template, step)
            if tree is not None:
                path = os.path.join(self._step_dir(manifest["step"]),
                                    "arrays.npz")
                with np.load(path) as z:
                    saved = {k: z[k] for k in z.files}
                same = []
                tree_map_with_names(lambda name, t: same.append(
                    np.array_equal(_host(t)[0], saved[name])
                    and _host(t)[0].dtype == saved[name].dtype), tree)
                devices = {str(t.device) for t in tree_leaves(tree)}
                rec["restored"].append((manifest["step"], len(same),
                                        all(same), sorted(devices)))
            return tree, manifest

    out = io.StringIO()
    train.make_step, train.CheckpointManager = timed_make_step, Checked
    try:
        with contextlib.redirect_stdout(out):
            loss, report = train.main(argv)
    finally:
        train.make_step, train.CheckpointManager = make_step, manager
    lines = out.getvalue().splitlines()
    for line in lines[:3] + (["  ..."] if len(lines) > 6 else []) + \
            lines[-3:]:
        print(f"  {line[:400]}")
    return loss, report, rec


def train_path(smi, dev, smoke=False):
    """Phase 15b-e: training on the card.  15b `launch.train.main` on
    llama3.2-1b's `full_config()` (bf16 params, fp32 moments), TRAIN_BATCH
    x TRAIN_SEQ, TRAIN_STEPS steps, no checkpoint inside the run: loss
    finite and falling, n_layers x 2 attention launches a step (the
    forward and remat's recompute in the backward), step time, tokens/s,
    peak; 15c the smoke config with `--chaos` as `examples/train_lm.py`
    runs it: one restart, the restored state == the checkpoint's arrays
    bit for bit, eval loss < 4; 15d deepseek-moe-16b at full width, 28
    layers cut to MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS AdamW steps on one
    batch: every gradient finite, the router's and experts' non-zero, the
    loss falling, peak; 15e one BST step at `full_config()`, batch
    BST_TRAIN_BATCH: two bag launches, loss finite, the multi-hot table's
    gradient on 64 sampled rows == a host sum of the bags' gradients.
    Returns launches by sub-phase and kernel."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.data import recsys
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import segment_bag as bag_mod
    from repro_torch.models import bst, lm
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    launches = {}

    def zero():
        for mod in (flash_mod, bag_mod):
            for key in mod.launches:
                mod.launches[key] = 0

    # 15b. llama3.2-1b through the launcher ------------------------------------
    t0 = time.perf_counter()
    mod = configs.get(LM_ARCH)
    cfg = mod.smoke_config() if smoke else mod.full_config()
    batch, seq, steps = (2, 32, 4) if smoke else (TRAIN_BATCH, TRAIN_SEQ,
                                                  TRAIN_STEPS)
    key = flash_mod.route(cfg.compute_dtype, cfg.head_dim)
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", LM_ARCH, "--steps", str(steps), "--batch",
                str(batch), "--seq", str(seq), "--lr", str(TRAIN_LR),
                "--device", str(dev),
                "--ckpt-dir", ckpt, "--ckpt-every", str(steps + 1)] + (
                    ["--smoke"] if smoke else [])
        zero()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        loss, report, rec = _train_main(argv, flash_mod.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    launches["15b"] = dict(flash_mod.launches)
    per_step = cfg.n_layers * (1 + cfg.remat) * on_card
    check(all(n == per_step for n in rec["launches"])
          and launches["15b"][key] == per_step * steps
          + 4 * cfg.n_layers * on_card
          and sum(launches["15b"].values()) == launches["15b"][key],
          f"15b: {per_step} {key} launches a step (forward and remat's "
          f"recompute) and {cfg.n_layers} an eval batch: {rec['launches']}, "
          f"{launches['15b']}")
    check(all(np.isfinite(rec["loss"])) and rec["loss"][-1] < rec["loss"][0]
          and np.isfinite(loss) and report["restarts"] == 0,
          f"15b: losses finite and the last below the first: {rec['loss']}")
    step_ms = statistics.median(rec["step_s"][1:]) * 1e3
    numbers = {"15b": {"step_ms": step_ms, "step_ms_all": [
        round(t * 1e3, 3) for t in rec["step_s"]],
        "tokens_per_s": batch * seq / step_ms * 1e3, "peak_GB": peak,
        "loss_first": rec["loss"][0], "loss_last": rec["loss"][-1],
        "eval_loss": float(loss)}}
    print(f"  15b {cfg.name} training, batch {batch} x {seq}, {steps} steps "
          f"({str(cfg.param_dtype)[6:]} params, fp32 moments, remat "
          f"{cfg.remat}): step {step_ms:.3f} ms "
          f"(median of steps 2-{steps}), {numbers['15b']['tokens_per_s']:.1f} "
          f"tokens/s, peak device memory {peak} GB; loss {rec['loss'][0]:.4f}"
          f" -> {rec['loss'][-1]:.4f}, eval {loss:.4f}; launches "
          f"{launches['15b']} ({smi})")
    if on_card:
        torch.cuda.empty_cache()
    phase("training 15b: llama3.2-1b through the launcher", t0)

    # 15c. the restart path ----------------------------------------------------
    t0 = time.perf_counter()
    scfg = mod.smoke_config()
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", LM_ARCH, "--smoke", "--steps", "200", "--batch",
                "8", "--seq", "64", "--lr", "3e-3", "--ckpt-dir", ckpt,
                "--ckpt-every", "50", "--chaos", "--device", str(dev)]
        zero()
        loss, report, rec = _train_main(argv, flash_mod.launches)
    launches["15c"] = dict(flash_mod.launches)
    skey = flash_mod.route(scfg.compute_dtype, scfg.head_dim)
    n_steps = len(rec["step_s"])
    check(report["restarts"] == 1 and loss < 4.0 and n_steps == 220,
          f"15c: one restart (120 + 100 steps run: {n_steps}) and eval loss "
          f"{loss} < 4.0")
    check(len(rec["restored"]) == 1 and rec["restored"][0][0] == 100
          and rec["restored"][0][2]
          and rec["restored"][0][3] == [str(torch.device(dev.type, 0))
                                        if on_card else "cpu"],
          f"15c: the state restored at step 100 == the checkpoint's arrays "
          f"bit for bit, on {dev}: {rec['restored']}")
    check(launches["15c"][skey] == n_steps * scfg.n_layers * 2 * on_card
          + 4 * scfg.n_layers * on_card,
          f"15c: {skey} launches {launches['15c']}")
    numbers["15c"] = {"eval_loss": float(loss), "report": report,
                      "restored": rec["restored"][0],
                      "step_ms": statistics.median(rec["step_s"]) * 1e3}
    print(f"  15c chaos run: {report}, restored step 100 "
          f"({rec['restored'][0][1]} leaves bit for bit), eval loss "
          f"{loss:.4f}, step "
          f"{numbers['15c']['step_ms']:.3f} ms; launches {launches['15c']}")
    phase("training 15c: the restart path", t0)

    # 15d. deepseek-moe-16b at full width, depth cut -----------------------------
    t0 = time.perf_counter()
    mod = configs.get(MOE_ARCH)
    cfg = dataclasses.replace(mod.smoke_config() if smoke
                              else mod.full_config(),
                              n_layers=MOE_TRAIN_LAYERS)
    batch, seq = (2, 32) if smoke else (2, TRAIN_SEQ)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(MOE_SEED),
                            cfg)
    opt = adamw(MOE_TRAIN_LR, weight_decay=0.01)
    state = opt.init(params)
    b = next(TokenStream(cfg.vocab, batch, seq, seed=0))
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    zero()
    losses, experts_hit = [], []
    for i in range(MOE_TRAIN_STEPS):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = lm.loss_fn(leaves, b, cfg)
        loss.backward()
        grads = tree_map(lambda t: t.grad, leaves)
        check(all(bool(torch.isfinite(g.float()).all())
                  for g in tree_leaves(grads)), f"15d step {i}: every "
              "gradient finite")
        for lp in grads["layers"]:
            check(float(lp["router"].float().abs().max()) > 0
                  and all(float(lp[w].float().abs().max()) > 0
                          for w in ("we_gate", "we_up", "we_down")),
                  f"15d step {i}: the router's and the experts' gradients "
                  "non-zero")
        experts_hit.append([int((lp["we_down"].float().abs().amax((1, 2))
                                 > 0).sum()) for lp in grads["layers"]])
        losses.append(float(loss.detach()))
        params, state, _ = opt.update(grads, state, params)
        del leaves, grads
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    launches["15d"] = dict(flash_mod.launches)
    check(all(np.isfinite(losses))
          and all(a > b for a, b in zip(losses, losses[1:])),
          f"15d: the loss falls on the repeated batch: {losses}")
    numbers["15d"] = {"losses": losses, "experts_with_grad": experts_hit,
                      "peak_GB": peak}
    print(f"  15d {cfg.name}, {MOE_TRAIN_LAYERS} of 28 layers at full width "
          f"({cfg.n_params()} parameters), {MOE_TRAIN_STEPS} AdamW steps on "
          f"one {batch} x {seq} batch: loss {losses}, experts with a "
          f"gradient by layer {experts_hit}, peak device memory {peak} GB; "
          f"launches {launches['15d']} ({smi})")
    del params, state, b
    if on_card:
        torch.cuda.empty_cache()
    phase("training 15d: deepseek-moe-16b, two layers at full width", t0)

    # 15e. one BST training step ------------------------------------------------
    t0 = time.perf_counter()
    mod = configs.get("bst")
    cfg = mod.smoke_config() if smoke else mod.full_config()
    n = 64 if smoke else BST_TRAIN_BATCH
    params = bst.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    host = recsys.bst_batch(cfg, n, seed=0)
    b = recsys.to_tensors(host, dev)
    bags = []
    embedding_bag = bst.embedding_bag

    def recorded(table, ids, mode="sum", impl="auto"):
        out = embedding_bag(table, ids, mode, impl)
        out.retain_grad()
        bags.append((ids, out))
        return out

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    zero()
    bst.embedding_bag = recorded
    try:
        loss, metrics = bst.loss_fn(leaves, b, cfg)
        loss.backward()
    finally:
        bst.embedding_bag = embedding_bag
    if on_card:
        torch.cuda.synchronize()
    launches["15e"] = dict(bag_mod.launches)
    check(launches["15e"] == {"float32": 2 * on_card, "bfloat16": 0}
          and bool(torch.isfinite(loss)),
          f"15e: two f32 bag launches, loss finite: {launches['15e']}, "
          f"{float(loss.detach())}")
    table_grad = leaves["multihot_embed"].grad
    ids_all = torch.cat([ids.reshape(-1) for ids, _ in bags]).cpu().numpy()
    grad_all = torch.cat([out.grad[:, None].expand(-1, ids.shape[1], -1)
                          .reshape(-1, out.shape[1]) for ids, out in bags])
    grad_all = grad_all.double().cpu().numpy()
    present = np.unique(ids_all[ids_all >= 0])
    rows = present[np.random.default_rng(0).choice(len(present), 64,
                                                   replace=False)]
    want = np.stack([grad_all[ids_all == r].sum(0) for r in rows])
    got = table_grad[torch.from_numpy(rows).to(dev)].double().cpu().numpy()
    share = float(np.abs(got - want).max() / (BAG_GRAD_TOL
                                              * np.abs(want).max()))
    check(share <= 1, f"15e: the table gradient on 64 sampled rows == a host "
          f"sum of the bags' gradients within {BAG_GRAD_TOL} of the largest "
          f"(worst at {share} of that)")
    grads = tree_map(lambda t: t.grad, leaves)
    params, state, om = opt.update(grads, state, params)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)),
          "15e: the updated parameters are finite")

    def step():                        # a whole step, for its time
        lv = tree_map(lambda t: t.detach().requires_grad_(), params)
        bst.loss_fn(lv, b, cfg)[0].backward()
        opt.update(tree_map(lambda t: t.grad, lv), state, params)

    step_ms = event_ms(step, 3) if on_card else None
    numbers["15e"] = {"loss": float(loss.detach()),
                      "acc": float(metrics["acc"]),
                      "grad_norm": float(om["grad_norm"]), "share": share,
                      "peak_GB": peak, "step_ms": step_ms}
    print(f"  15e BST training step, batch {n}: loss "
          f"{float(loss.detach()):.5f}, acc {float(metrics['acc']):.4f}, "
          f"grad norm {float(om['grad_norm'])}"
          f"; table gradient on 64 rows == host sums (worst at "
          f"{share:.4f} of {BAG_GRAD_TOL}); launches {launches['15e']}; a "
          f"warm step {step_ms} ms (median of 3); peak "
          f"device memory {peak} GB ({smi})")
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    del params, state, leaves, grads, bags
    if on_card:
        torch.cuda.empty_cache()
    phase("training 15e: one BST step", t0)
    return launches


def _gnn_train(params, batch, cfg, steps, on_card):
    """`steps` AdamW steps of `models.gnn.loss_fn` on one batch: (losses,
    each step's event ms (None off the card), every gradient finite, the
    last step's gradient norm)."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    opt = adamw(GNN_LR, weight_decay=0.01)
    state = opt.init(params)
    losses, times, finite, gnorm = [], [], True, None
    for _ in range(steps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = gnn.loss_fn(leaves, batch, cfg)
        loss.backward()
        grads = tree_map(lambda t: t.grad, leaves)
        params, state, om = opt.update(grads, state, params)
        if on_card:
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        finite &= all(bool(torch.isfinite(g).all())
                      for g in tree_leaves(grads))
        losses.append(float(loss.detach()))
        gnorm = float(om["grad_norm"])
        del leaves, grads
    return losses, times or None, finite, gnorm


def gnn_path(smi, dev, smoke=False):
    """Phase 16: the GNN substrate (`repro_torch.models.gnn`) on the card,
    each model at its `full_config()` widths: 16a GAT gat-cora on
    `cora_like()` (full_graph_sm), and GAT adapted to minibatch_lg (d_in
    602, 41 classes, as JAX's `_adapt_gnn_cfg`) on one `sampled_batch` of
    `NeighborSampler(fanouts=(15, 10))` over `random_csr(232,965, 492)`
    (reddit's shape, built on the host); 16b SchNet and DimeNet
    (triplet_chunks 1 and 4) on `molecule_batch(128, 30, 64)`; 16c
    MeshGraphNet (15 layers, remat) on `mesh_grid_graph(512, 512)`; 16d the
    `gnn_cc_pipeline_torch` example, 10 steps, on the card and on the CPU.
    For each model and graph: the card's forward == the port on the CPU
    (same parameters and batch, fp32, TF32 off) within GNN_FWD_TOL of the
    output's largest |value|; GNN_TRAIN_STEPS AdamW steps on the batch,
    every gradient finite and the last loss below the first; warm forward
    and step ms (CUDA events), peak GB; a profile of one 16c training step;
    16d's per-step component counts == the CPU run's.  Every kernel launch
    counter reads 0 after it.  `smoke` runs the smoke configs on small
    graphs (a CPU rehearsal, nothing timed).  Returns (the launches counted
    over the phase, by kernel module; the minibatch_lg host batch, which
    phase 18d reuses)."""
    import dataclasses
    import importlib.util
    import torch
    from repro_torch import configs
    from repro_torch.configs import gnn_shapes
    from repro_torch.data import graphs
    from repro_torch.interop import gnn_batch_from_numpy
    from repro_torch.kernels import block_pathcompress, flash_attention, \
        fused_local_phase, segment_bag, steepest_neighbor
    from repro_torch.models import gnn
    from repro_torch.tree import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    mods = (fused_local_phase, steepest_neighbor, block_pathcompress,
            segment_bag, flash_attention)
    for mod in mods:
        for key in mod.launches:
            mod.launches[key] = 0
    shapes = gnn_shapes.SMOKE_SHAPES if smoke else gnn_shapes.SHAPES
    make = "smoke_config" if smoke else "full_config"
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 matmuls stay off TF32 (the CPU comparison's tolerance)")
    numbers = {}

    def run(label, cfg, host, fwd_reps=5):
        """One model on one batch: the card's forward against the CPU's,
        training, times and peak; returns (card params, card batch, the
        card's output)."""
        t0 = time.perf_counter()
        params = gnn.init_params(torch.Generator().manual_seed(GNN_SEED),
                                 cfg)
        n_params = sum(t.numel() for t in tree_leaves(params))
        want = gnn.apply(params, gnn_batch_from_numpy(host, cpu), cfg)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        card = tree_map(lambda t: t.to(dev), params)
        batch = gnn_batch_from_numpy(host, dev)
        with torch.no_grad():
            got = gnn.apply(card, batch, cfg)
        err = float((got.cpu() - want).abs().max())
        top = float(want.abs().max())
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all())
              and err <= GNN_FWD_TOL * top,
              f"{label}: the card's forward == the CPU's within "
              f"{GNN_FWD_TOL} of {top} (err {err})")
        fwd_ms = None
        if on_card:
            with torch.no_grad():
                fwd_ms = event_ms(lambda: gnn.apply(card, batch, cfg),
                                  fwd_reps)
        losses, step_ms, finite, gnorm = _gnn_train(
            card, batch, cfg, GNN_TRAIN_STEPS, on_card)
        check(finite and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"{label}: gradients finite and the loss falling over "
              f"{GNN_TRAIN_STEPS} AdamW steps: {losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        step = statistics.median(step_ms[1:]) if on_card else None
        numbers[label] = {"params": n_params, "fwd_ms": fwd_ms,
                          "step_ms": step, "step_ms_all": step_ms,
                          "peak_GB": peak, "fwd_err": err, "out_max": top,
                          "losses": losses, "grad_norm": gnorm,
                          "seconds": time.perf_counter() - t0}
        print(f"  {label} ({cfg.name}, {n_params} parameters): forward "
              f"{ms_text(fwd_ms)} (median of {fwd_reps}), training step "
              f"{ms_text(step)} (median of steps 2-{GNN_TRAIN_STEPS}), "
              f"peak device memory {peak} GB; card == CPU within {err} "
              f"(largest |out| {top}); loss {losses} ({smi})", flush=True)
        return card, batch, got

    # 16a. GAT: full_graph_sm, then minibatch_lg ------------------------------
    t0 = time.perf_counter()
    cfg = getattr(configs.get("gat-cora"), make)()
    shp = shapes["full_graph_sm"]
    host = graphs.cora_like(0, shp["n_nodes"], shp["n_edges"],
                            shp["d_feat"], shp["n_classes"])
    check(host["node_feat"].shape[1] == cfg.d_in, "cora's feature width")
    run("16a full_graph_sm", cfg, host)
    shp = shapes["minibatch_lg"]
    t1 = time.perf_counter()
    degree = round(shp["n_edges"] / shp["n_nodes"])     # 492 for reddit
    indptr, indices = graphs.random_csr(shp["n_nodes"], degree, seed=0)
    csr_s = time.perf_counter() - t1
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((shp["n_nodes"], shp["d_feat"])).astype(
        np.float32)
    labels = rng.integers(0, shp["n_classes"], shp["n_nodes"])
    t1 = time.perf_counter()
    sampler = graphs.NeighborSampler(indptr, indices, shp["fanout"], seed=0)
    host = graphs.sampled_batch(sampler, feats, labels, shp["batch_nodes"])
    sample_s = time.perf_counter() - t1
    n_csr = len(indices)
    real = int(host["node_mask"].sum()), int(host["edge_mask"].sum())
    pad = (sampler.max_sample_nodes(shp["batch_nodes"]),
           sampler.max_sample_edges(shp["batch_nodes"]))
    check((len(host["node_mask"]), len(host["senders"])) == pad
          and (smoke or pad == (shp["sample_nodes"], shp["sample_edges"])),
          f"16a minibatch_lg: the sampler pads to {pad} nodes and edges, "
          "gnn_shapes' sizes")
    cfg = dataclasses.replace(cfg, d_in=shp["d_feat"],
                              n_classes=shp["n_classes"])
    del indptr, indices, feats, labels, sampler
    run("16a minibatch_lg", cfg, host)
    minibatch = host                    # phase 18d's sampled batch
    numbers["16a minibatch_lg"].update(csr_build_s=csr_s, sample_s=sample_s,
                                       csr_edges=n_csr, real=real)
    print(f"  16a minibatch_lg host: random_csr({shp['n_nodes']}, "
          f"{degree}) built in {csr_s:.3f} s "
          f"({n_csr} directed edges), one sampled batch in {sample_s:.3f} s "
          f"({real[0]} of {pad[0]} nodes and {real[1]} of {pad[1]} edges "
          "real)")
    del host
    phase("gnn 16a: GAT, full_graph_sm and minibatch_lg", t0)

    # 16b. SchNet and DimeNet on the molecule batch ---------------------------
    t0 = time.perf_counter()
    shp = shapes["molecule"]
    host = graphs.molecule_batch(shp["batch"], shp["n_nodes"],
                                 shp["n_edges"], seed=0)
    run("16b SchNet", getattr(configs.get("schnet"), make)(), host)
    dcfg = getattr(configs.get("dimenet"), make)()
    outs = {chunks: run(f"16b DimeNet triplet_chunks {chunks}",
                        dataclasses.replace(dcfg, triplet_chunks=chunks),
                        host)[2].cpu()
            for chunks in (1, 4)}
    err = float((outs[4] - outs[1]).abs().max())
    check(err <= GNN_FWD_TOL * float(outs[1].abs().max()),
          f"16b DimeNet: 4 triplet chunks == 1 within {GNN_FWD_TOL} ({err})")
    print(f"  16b DimeNet: {len(host['triplet_src'])} triplet slots "
          f"({int(host['triplet_mask'].sum())} real); 4 chunks == 1 within "
          f"{err}")
    del host
    phase("gnn 16b: SchNet and DimeNet, molecule", t0)

    # 16c. MeshGraphNet on the 512 x 512 mesh ---------------------------------
    t0 = time.perf_counter()
    side = 16 if smoke else GNN_MESH_SIDE
    host = graphs.mesh_grid_graph(side, side, seed=0)
    cfg = getattr(configs.get("meshgraphnet"), make)()
    print(f"  16c mesh {side} x {side}: {side * side} nodes, "
          f"{len(host['senders'])} directed edges")
    card, batch, _ = run("16c MeshGraphNet", cfg, host, fwd_reps=3)
    if on_card:
        def step():
            leaves = tree_map(lambda t: t.detach().requires_grad_(), card)
            gnn.loss_fn(leaves, batch, cfg)[0].backward()

        profile(step, "16c MeshGraphNet forward + backward (remat)", top=12)
    del host, card, batch
    if on_card:
        torch.cuda.empty_cache()
    phase("gnn 16c: MeshGraphNet, 512 x 512 mesh", t0)

    # 16d. the DPC-in-GNN pipeline twin ---------------------------------------
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "gnn_cc_pipeline_torch", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "examples",
            "gnn_cc_pipeline_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    steps = ["--steps", "2" if smoke else "10"]
    t1 = time.perf_counter()
    rec = example.main(["--device", str(dev)] + steps)
    run_s = time.perf_counter() - t1
    want = example.main(["--device", "cpu"] + steps)
    counts = [(r["nodes"], r["components"]) for r in rec]
    check(counts == [(r["nodes"], r["components"]) for r in want]
          and all(np.isfinite(r["loss"]) for r in rec),
          f"16d: the per-step component counts on {dev} == the CPU's: "
          f"{counts}")
    numbers["16d"] = {"counts": counts, "seconds": run_s,
                      "losses": [r["loss"] for r in rec]}
    print(f"  16d gnn_cc_pipeline_torch, {len(rec)} steps on {dev} in "
          f"{run_s:.3f} s: (nodes, DPC components) {counts} == the CPU "
          "run's")
    phase("gnn 16d: the DPC-in-GNN pipeline twin", t0)

    if on_card:
        torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[1]: dict(mod.launches)
                for mod in mods}
    print(f"  phase 16 kernel launches: {launches}")
    check(all(v == 0 for d in launches.values() for v in d.values()),
          "phase 16 launched no kernel (the GNN path reaches none)")
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    return launches, minibatch


def _dlm_configs(smoke):
    """Phase 17's configs: "a" (llama3.2-1b cut to DLM_LAYERS), "b"
    (llama3.2-1b whole), "c" (deepseek-moe-16b cut to DLM_MOE_LAYERS, fp32,
    shard_map) and "c_local", its one-rank reference (the "local" dispatch,
    dp_shards = the mesh's data size); "c16" and "c16_local" the same in
    the config's bf16.  `smoke`: the smoke configs."""
    import dataclasses
    import torch
    from repro_torch import configs

    def get(arch):
        mod = configs.get(arch)
        return mod.smoke_config() if smoke else mod.full_config()

    llama, moe16 = get("llama3.2-1b"), get(MOE_ARCH)
    moe16 = dataclasses.replace(moe16, n_layers=DLM_MOE_LAYERS)
    moe = dataclasses.replace(moe16, param_dtype=torch.float32,
                              compute_dtype=torch.float32)

    def dispatch(cfg, **kw):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **kw))

    local = {"dispatch": "local", "dp_shards": DLM_MESH[0]}
    return {"a": dataclasses.replace(llama, n_layers=min(DLM_LAYERS,
                                                         llama.n_layers)),
            "b": llama, "c": dispatch(moe, dispatch="shard_map"),
            "c_local": dispatch(moe, **local),
            "c16": dispatch(moe16, dispatch="shard_map"),
            "c16_local": dispatch(moe16, **local)}


@contextlib.contextmanager
def _moe_probe(slots=None, routes=None, replay=None):
    """Phase 17c's view of `models.lm`'s MoE while it runs: each dispatch's
    (kept, dropped) (token, choice) counts appended to `slots` (0-d
    tensors), each routing's top-k experts (T, k) to `routes`; `replay`, a
    list of top-k expert tensors that the routings take in turn in place
    of their own, each with its own probabilities' weights for them."""
    from repro_torch.models import lm
    tables, route = lm._dispatch_tables, lm._route

    def dispatch(topi, topv, T, E, C):
        table, wtab, slot = tables(topi, topv, T, E, C)
        if slots is not None:
            kept = (slot < E * C).sum()
            slots.append((kept, slot.numel() - kept))
        return table, wtab, slot

    def routing(x2d, lp, cfg):
        probs, topi, topv = route(x2d, lp, cfg)
        if replay is not None:
            topi = replay.pop(0).to(topi.device)
            topv = probs.gather(1, topi)
            topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        if routes is not None:
            routes.append(topi.cpu())
        return probs, topi, topv

    lm._dispatch_tables, lm._route = dispatch, routing
    try:
        yield
    finally:
        lm._dispatch_tables, lm._route = tables, route


def _slot_sums(slots):
    """(kept, dropped) over `_moe_probe`'s counts."""
    return (sum(int(k) for k, _ in slots), sum(int(d) for _, d in slots))


def _bf16_ulps(got, want, dim=-1):
    """The largest |got - want| in bf16 ulps of the largest |want| along
    `dim` (None: the whole tensor)."""
    import torch
    got, want = got.float(), want.float()
    top = want.abs().amax() if dim is None else want.abs().amax(
        dim, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - 7)
    return float(((got - want).abs() / ulp).max())


def _dlm_sizes(smoke):
    """(17a's batch, seq; 17b's cache length, chunk; 17c's batch, seq)."""
    if smoke:
        return {"a": (4, 32), "b": (64, 16), "c": (2, 32)}
    return {"a": (DLM_BATCH, DLM_SEQ), "b": (DLM_LONG_LEN, DLM_LONG_CHUNK),
            "c": (DLM_MOE_BATCH, DLM_MOE_SEQ)}


def _long_chunk(cfg, layer, chunk, which, size, dev, draw=0):
    """Positions [chunk * size, (chunk + 1) * size) of layer `layer`'s K or
    V cache, (1, Hkv, size, dh) in the compute dtype, drawn from a
    generator seeded by (layer, chunk, which, draw) alone, so a rank draws
    its own positions and the one-rank reference the same values; K is
    scaled by DLM_LONG_KSCALE.  `draw` > 0: another draw of the same."""
    import torch
    seed = (DLM_SEED * 1_000_003 + layer * 4099 + chunk * 2 + (which == "v")
            + draw * 7_919_000)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, cfg.n_kv_heads, size, cfg.head_dim), generator=g,
                    device=dev)
    return (x * DLM_LONG_KSCALE if which == "k" else x).to(cfg.compute_dtype)


def _fill_long(cache, cfg, base, lo, hi, chunk, dev, draw=0):
    """Positions [lo, hi) (multiples of `chunk`) of every layer of the K
    and V caches (L, 1, Hkv, S, dh), whose index 0 holds position `base`,
    drawn by `_long_chunk`."""
    for layer in range(cfg.n_layers):
        for c in range(lo // chunk, hi // chunk):
            for w in ("k", "v"):
                cache[w][layer, :, :, c * chunk - base:(c + 1) * chunk
                         - base] = _long_chunk(cfg, layer, c, w, chunk, dev,
                                               draw)


def _written_slots(cache, cfg, base, chunk, dev):
    """Every (layer, position) of the K and V caches (index 0 at position
    `base`) that no longer holds its seeded value, with the value there:
    {"k": [(layer, position, (Hkv, dh) fp32 on the host)], "v": [...]}."""
    out = {"k": [], "v": []}
    n = cache["k"].shape[3]
    for layer in range(cfg.n_layers):
        for c in range(base // chunk, (base + n) // chunk):
            a = c * chunk - base
            for w in ("k", "v"):
                blk = cache[w][layer, 0, :, a:a + chunk]
                fill = _long_chunk(cfg, layer, c, w, chunk, dev)[0]
                for p in (blk != fill).any(-1).any(0).nonzero()[:, 0]:
                    out[w].append((layer, base + a + int(p),
                                   blk[:, int(p)].float().cpu().clone()))
    return out


def _flat(tree):
    from repro_torch.tree import tree_map_with_names
    out = {}
    tree_map_with_names(lambda n, t: out.__setitem__(n, t), tree)
    return out


def _flat_specs(cfg):
    from repro_torch.models import lm
    tree = lm.param_logical_specs(cfg)
    out = {k: tree[k] for k in ("embed", "ln_f", "unembed")}
    out.update({f"layers/{i}/{k}": v for i, lp in enumerate(tree["layers"])
                for k, v in lp.items()})
    return out


def _dlm_rank(rank, store, tmp, device, smoke):
    """Phase 17's ranks: 17a, 17b and 17c in turn, each rank writing its
    records to `tmp` (17a's gradient and updated parameter blocks to a
    file of their own).  Launch counts are set to 0 just before each
    measured call and read just after; 17a's kernel-vs-plain checks run
    after that."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod, ops, ref
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.meshctx import LOGICAL_AXES, Mesh, use_mesh
    from repro_torch.tree import tree_map

    _rank_setup(rank, DLM_WORLD, store, "gloo", device)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfgs = _dlm_configs(smoke)
    cfg_a, cfg_b = cfgs["a"], cfgs["b"]
    sizes = _dlm_sizes(smoke)
    toks = torch.load(os.path.join(tmp, "dlm_tokens.pt"), weights_only=True)
    mesh = Mesh(DLM_MESH, ("data", "model"), dev)
    long_mesh = Mesh((DLM_WORLD, 1), ("data", "model"), dev)
    dp = LOGICAL_AXES["dp"]
    out = {"coords": mesh.coords}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset():
        for k in flash_mod.launches:
            flash_mod.launches[k] = 0
        if on_card:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def draw(cfg, seed, m):
        params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                                cfg)
        whole = {n: t.numel() for n, t in _flat(params).items()}
        return lm.shard_params(params, cfg, m), whole

    # 17a: one AdamW step of llama3.2-1b (cut) on (2, 2), SP on ----------
    local, whole = draw(cfg_a, DLM_SEED, mesh)
    specs = _flat_specs(cfg_a)
    shares = {n: whole[n] / t.numel() for n, t in _flat(local).items()
              if "fsdp" in specs[n] and "tp" in specs[n]}
    batch = {k: mesh.block(toks["a"].to(dev), dp, 0)
             for k in ("tokens", "labels")}
    opt = adamw(DLM_LR, norm_fn=lm.global_norm_fn(cfg_a, mesh))
    state = opt.init(local)
    with use_mesh(mesh), torch.no_grad():
        lm.loss_fn(local, batch, cfg_a)             # warm-up, not counted
    seen, plain_call = [], ops.flash_attention

    def record(q, k, v, **kw):
        seen.append(tuple(t.detach().clone() for t in (q, k, v)))
        return plain_call(q, k, v, **kw)

    reset()
    t = time.perf_counter()
    ops.flash_attention = record
    try:
        with use_mesh(mesh):
            leaves = tree_map(lambda p: p.detach().requires_grad_(), local)
            loss, _ = lm.loss_fn(leaves, batch, cfg_a)
            loss.backward()
            grads = tree_map(lambda p: p.grad, leaves)
            new, state, om = opt.update(grads, state, local)
        sync()
    finally:
        ops.flash_attention = plain_call
    rec = {"loss": float(loss), "grad_norm": float(om["grad_norm"]),
           "step_ms": (time.perf_counter() - t) * 1e3, "peak_gb": peak(),
           "launches": dict(flash_mod.launches), "shares": shares,
           "attn": []}
    if on_card:                     # every launch of the step == plain
        for q, k, v in seen:
            with torch.no_grad():
                got = flash_mod.flash_attention(q.contiguous(),
                                                k.contiguous(),
                                                v.contiguous(), causal=True)
                want = ref.flash_attention_kernel_ref(q, k, v, causal=True,
                                                      block_k=512)
            share, at = limit_share(got, want, ATTN_BF16_FULL)
            rec["attn"].append((tuple(q.shape), tuple(k.shape), share, at,
                                float((got.float() - want.float()).abs()
                                      .max())))
    torch.save({"new": {n: t.detach().cpu() for n, t in _flat(new).items()},
                "grad": {n: t.detach().cpu()
                         for n, t in _flat(grads).items()}},
               os.path.join(tmp, f"dlm_17a_rank{rank}.pt"))
    out["17a"] = rec
    del local, new, state, leaves, grads, loss, batch, seen
    reset()

    # 17b: context-parallel decode, the cache over all ranks ---------------
    local, _ = draw(cfg_b, DLM_SEED + 1, long_mesh)
    length, chunk = sizes["b"]
    n_seq = long_mesh.axis_size(("data", "model"))
    s_loc = length // n_seq
    lo = long_mesh.index(("data", "model")) * s_loc
    cache = {w: torch.empty((cfg_b.n_layers, 1, cfg_b.n_kv_heads, s_loc,
                             cfg_b.head_dim), dtype=cfg_b.compute_dtype,
                            device=dev) for w in ("k", "v")}
    _fill_long(cache, cfg_b, lo, lo, lo + s_loc, chunk, dev)
    cache.update(length=length - DLM_LONG_STEPS,
                 logical=lm.LONG_CACHE_LOGICAL)
    block = tuple(cache["k"].shape)
    reset()
    logits, times = [], []
    with use_mesh(long_mesh), torch.no_grad():
        for i in range(DLM_LONG_STEPS):
            sync()
            t = time.perf_counter()
            lg, cache = lm.decode_step(local, cache,
                                       toks["b"][i].view(1, 1).to(dev), cfg_b)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            logits.append(lg.float().cpu())
    out["17b"] = {"logits": torch.cat(logits), "step_ms": times,
                  "peak_gb": peak(), "launches": dict(flash_mod.launches),
                  "length": cache["length"], "block": block, "lo": lo,
                  "written": _written_slots(cache, cfg_b, lo, chunk, dev)}
    del local, cache, lg
    reset()

    # 17c: the shard_map MoE on (2, 2), fp32 then bf16 ----------------------
    for key, seed in (("c", DLM_SEED + 2), ("c16", DLM_SEED + 3)):
        local, _ = draw(cfgs[key], seed, mesh)
        tokens = mesh.block(toks["c"].to(dev), dp, 0)
        reset()
        slots, routes = [], []
        t = time.perf_counter()
        with _moe_probe(slots, routes), use_mesh(mesh), torch.no_grad():
            lg, _ = lm.prefill(local, tokens, cfgs[key])
        sync()
        ms = (time.perf_counter() - t) * 1e3
        kept, dropped = _slot_sums(slots)
        out[f"17{key}"] = {"logits": lg.float().cpu(), "prefill_ms": ms,
                           "peak_gb": peak(),
                           "launches": dict(flash_mod.launches),
                           "kept": kept, "dropped": dropped,
                           "routes": routes}
        del local, lg
    torch.save(out, os.path.join(tmp, f"dlm_rank{rank}.pt"))


def _assemble_blocks(blocks, coords, spec, sizes):
    """The whole tensor from each rank's block (host): rank r's block goes
    at its block index along each dimension's axes (`spec`, physical)."""
    import math
    import torch
    shape = [n * math.prod(sizes[a] for a in (p if isinstance(p, tuple)
                                              else (p,)))
             if p is not None else n for n, p in zip(blocks[0].shape, spec)]
    out = torch.empty(shape, dtype=blocks[0].dtype)
    for blk, c in zip(blocks, coords):
        index = []
        for d, p in enumerate(spec):
            axes = () if p is None else (p if isinstance(p, tuple) else (p,))
            i = int(np.ravel_multi_index([c[a] for a in axes],
                                         [sizes[a] for a in axes])) \
                if axes else 0
            n = blk.shape[d]
            index.append(slice(i * n, (i + 1) * n))
        out[tuple(index)] = blk
    return out


def distributed_lm_path(smi, dev, smoke=False):
    """Phase 17: the distributed LM (`runtime.meshctx`, `models.lm` on a
    mesh) on DLM_WORLD gloo ranks sharing the card (`dev`; on the CPU with
    `smoke`, the smoke configs at small sizes, nothing timed and no kernel
    compared: a rehearsal), each sub-phase held to the same work on one
    rank in this process; then 17d, the example twins.  Returns
    (flash_attention launches by sub-phase and rank, the fused kernel's
    launches in 17d's single-device parts, the largest attention error)."""
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from repro_torch.kernels import fused_local_phase as kmod
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.meshctx import logical_to_spec
    from repro_torch.tree import tree_map

    on_card = dev.type == "cuda"
    cfgs = _dlm_configs(smoke)
    cfg_a, cfg_b = cfgs["a"], cfgs["b"]
    sizes = _dlm_sizes(smoke)
    mesh_sizes = dict(zip(("data", "model"), DLM_MESH))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_reset():
        if on_card:
            sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def moe_prefill(key, seed, tokens, **probe):
        """17c's one-rank prefill of cfgs[key]: (logits on the host, ms,
        (kept, dropped))."""
        params = lm.init_params(gen.manual_seed(seed), cfgs[key])
        slots = []
        peak_reset()
        t = time.perf_counter()
        with _moe_probe(slots, **probe), torch.no_grad():
            lg, _ = lm.prefill(params, tokens, cfgs[key])
        sync()
        return lg.float().cpu(), (time.perf_counter() - t) * 1e3, \
            _slot_sums(slots)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dlm_")
    try:
        # one-rank references in this process ------------------------------
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev)
        b, s = sizes["a"]
        params = lm.init_params(gen.manual_seed(DLM_SEED), cfg_a)
        tok_a = torch.randint(0, cfg_a.vocab, (b, s), device=dev,
                              generator=gen.manual_seed(DLM_SEED + 10))
        with torch.no_grad():                       # warm-up, as the ranks
            lm.loss_fn(params, {"tokens": tok_a, "labels": tok_a}, cfg_a)
        peak_reset()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        t = time.perf_counter()
        loss, _ = lm.loss_fn(leaves, {"tokens": tok_a, "labels": tok_a},
                             cfg_a)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        new, _, om = adamw(DLM_LR).update(grads, adamw(DLM_LR).init(params),
                                          params)
        sync()
        ref_a = {"loss": float(loss), "grad_norm": float(om["grad_norm"]),
                 "ms": (time.perf_counter() - t) * 1e3, "peak": peak(),
                 "p0": {n: p.detach().cpu() for n, p in
                        _flat(params).items()},
                 "grad": {n: g.detach().cpu() for n, g in
                          _flat(grads).items()},
                 "new": {n: p.detach().cpu() for n, p in _flat(new).items()}}
        del params, leaves, grads, new, loss
        print(f"  17a one rank: {cfg_a.name} cut to {cfg_a.n_layers} layers, "
              f"{b} x {s}, loss {ref_a['loss']}, grad norm "
              f"{ref_a['grad_norm']}, step {ref_a['ms']} ms, peak "
              f"{ref_a['peak']} GB ({smi})")

        length, chunk = sizes["b"]
        s_loc = length // DLM_WORLD
        params = lm.init_params(gen.manual_seed(DLM_SEED + 1), cfg_b)
        cache = {w: torch.empty((cfg_b.n_layers, 1, cfg_b.n_kv_heads, length,
                                 cfg_b.head_dim), dtype=cfg_b.compute_dtype,
                                device=dev) for w in ("k", "v")}
        _fill_long(cache, cfg_b, 0, 0, length, chunk, dev)
        cache["length"] = length - DLM_LONG_STEPS
        toks_b = [torch.randint(0, cfg_b.vocab, (), device=dev,
                                generator=gen.manual_seed(DLM_SEED + 11))]
        ref_b, ms_b = [], []
        peak_reset()
        with torch.no_grad():
            for _ in range(DLM_LONG_STEPS):
                sync()
                t = time.perf_counter()
                lg, cache = lm.decode_step(params, cache,
                                           toks_b[-1].view(1, 1), cfg_b)
                sync()
                ms_b.append((time.perf_counter() - t) * 1e3)
                ref_b.append(lg.float().cpu())
                toks_b.append(lg[0].argmax())
        peak_b = peak()
        new_pos = slice(length - DLM_LONG_STEPS, length)
        written_b = {w: cache[w][:, 0, :, new_pos].float().cpu().clone()
                     for w in ("k", "v")}
        # the gate's reach: step 0 again with one rank's slice drawn anew
        reach = []
        with torch.no_grad():
            for r in range(DLM_WORLD):
                span = (r * s_loc, (r + 1) * s_loc)
                _fill_long(cache, cfg_b, 0, *span, chunk, dev, draw=1)
                cache["length"] = length - DLM_LONG_STEPS
                lg, cache = lm.decode_step(params, cache,
                                           toks_b[0].view(1, 1), cfg_b)
                lg = lg.float().cpu()
                reach.append((float((lg - ref_b[0]).abs().max()
                                    / ref_b[0].abs().max()),
                              int(lg[0].argmax())))
                _fill_long(cache, cfg_b, 0, *span, chunk, dev)
        cache_gb = (cache["k"].numel() * cache["k"].element_size() * 2
                    / 1e9)
        del params, cache, lg
        print(f"  17b one rank: {cfg_b.name} ({cfg_b.n_layers} layers), a "
              f"{length}-position cache of {cache_gb} GB, K drawn at "
              f"{DLM_LONG_KSCALE} sigma, {DLM_LONG_STEPS} greedy steps "
              f"{ms_b} ms, peak {peak_b} GB ({smi})")
        for r, (dev_r, tok_r) in enumerate(reach):
            print(f"  17b reach: rank {r}'s slice drawn anew moves step 0's "
                  f"logits by {dev_r} of the row's largest (greedy token "
                  f"{tok_r}, one rank's {int(toks_b[1])})")
            check(dev_r > DLM_LONG_TOL,
                  f"17b: a new draw of rank {r}'s slice moves step 0's "
                  f"logits by {dev_r} > {DLM_LONG_TOL} of the row's largest"
                  f" (the gate sees every slice)")

        b, s = sizes["c"]
        tok_c = torch.randint(0, cfgs["c"].vocab, (b, s), device=dev,
                              generator=gen.manual_seed(DLM_SEED + 12))
        ref_c, ms_c, (kept, dropped) = moe_prefill("c_local", DLM_SEED + 2,
                                                   tok_c)
        print(f"  17c one rank: {cfgs['c_local'].name} cut to "
              f"{DLM_MOE_LAYERS} layers, fp32, local dispatch over "
              f"{DLM_MESH[0]} shards, {b} x {s} prefill {ms_c} ms, {kept} "
              f"slots kept, {dropped} dropped, peak {peak()} GB ({smi})")
        torch.save({"a": tok_a.cpu(), "b": torch.stack(toks_b).cpu(),
                    "c": tok_c.cpu()}, os.path.join(tmp, "dlm_tokens.pt"))
        del tok_a, toks_b
        peak_reset()
        phase("17 one-rank references", t0)

        # the ranks ---------------------------------------------------------
        t0 = time.perf_counter()
        mp.spawn(_dlm_rank, args=(os.path.join(tmp, "store_17"), tmp,
                                  dev.type, smoke), nprocs=DLM_WORLD)
        recs = [torch.load(os.path.join(tmp, f"dlm_rank{r}.pt"),
                           weights_only=True) for r in range(DLM_WORLD)]
        phase("17 ranks (17a, 17b, 17c)", t0)

        # 17a gates ---------------------------------------------------------
        t0 = time.perf_counter()
        launches = {"17a": {}, "17b": {}, "17c": {}, "17c16": {}}
        attn_err = 0.0
        key_a = "bfloat16" if cfg_a.compute_dtype == torch.bfloat16 \
            else "float32"
        for r, rec in enumerate(recs):
            a = rec["17a"]
            launches["17a"][r] = a["launches"]
            print(f"  17a rank {r} {rec['coords']}: loss {a['loss']}, grad "
                  f"norm {a['grad_norm']}, step {a['step_ms']} ms, peak "
                  f"{a['peak_gb']} GB, launches {a['launches']} ({smi})")
            check(abs(a["loss"] - ref_a["loss"]) <= DLM_LOSS_TOL,
                  f"17a rank {r}: loss {a['loss']} within {DLM_LOSS_TOL} of "
                  f"one rank's {ref_a['loss']}")
            check(abs(a["grad_norm"] - ref_a["grad_norm"])
                  <= DLM_NORM_RTOL * ref_a["grad_norm"],
                  f"17a rank {r}: gradient norm {a['grad_norm']} within "
                  f"{DLM_NORM_RTOL} of {ref_a['grad_norm']}")
            check(a["shares"] and set(a["shares"].values()) == {DLM_WORLD},
                  f"17a rank {r}: holds 1/{DLM_WORLD} of every FSDP x TP "
                  f"leaf ({sorted(set(a['shares'].values()))})")
            if on_card:
                n = a["launches"][key_a]
                check(n == 2 * cfg_a.n_layers and sum(
                    a["launches"].values()) == n and len(a["attn"]) == n,
                      f"17a rank {r}: {n} flash_attention launches, one a "
                      f"layer forward and one in remat's recompute, each "
                      f"compared")
                worst_share = 0.0
                for i, (qs, ks, share, at, err) in enumerate(a["attn"]):
                    attn_err = max(attn_err, err)
                    worst_share = max(worst_share, share)
                    check(share <= 1, f"17a rank {r}: flash_attention launch"
                          f" {i} at q {qs}, k/v {ks} == plain within "
                          f"{ATTN_BF16_FULL} (worst element at {share} of "
                          f"its limit, {at}; max abs err {err})")
                print(f"  17a rank {r}: each of its {n} launches at q "
                      f"{a['attn'][0][0]}, k/v {a['attn'][0][1]} == plain, "
                      f"worst element at {worst_share:.4f} of its limit")
        specs = _flat_specs(cfg_a)

        class Axes:
            axis_names = ("data", "model")

        coords = [rec["coords"] for rec in recs]
        blocks = [torch.load(os.path.join(tmp, f"dlm_17a_rank{r}.pt"),
                             weights_only=True) for r in range(DLM_WORLD)]
        worst, worst_g, moved, agree, low = 0.0, (0.0, ""), 0, 0, (1.0, "")
        still = []
        for name, spec in specs.items():
            pspec = logical_to_spec(spec, Axes)
            g = _assemble_blocks([blk["grad"][name] for blk in blocks],
                                 coords, pspec, mesh_sizes).to(dev)
            ulps = _bf16_ulps(g, ref_a["grad"][name].to(dev), dim=None)
            worst_g = max(worst_g, (ulps, name))
            check(ulps <= DLM_GRAD_ULPS, f"17a {name}: the gathered gradient"
                  f" within {DLM_GRAD_ULPS} bf16 ulps of the leaf's largest "
                  f"|grad| of one rank's ({ulps} ulps)")
            got = _assemble_blocks([blk["new"][name] for blk in blocks],
                                   coords, pspec, mesh_sizes)
            got, want = got.to(dev).float(), ref_a["new"][name].to(
                dev).float()
            p0 = ref_a["p0"][name].to(dev).float()
            bound = 2 * DLM_LR + 2 ** -6 * torch.maximum(got.abs(),
                                                         want.abs())
            share = float(((got - want).abs() / bound).max())
            worst = max(worst, share)
            check(share <= 1, f"17a {name}: updated parameters within 2 lr "
                  f"+ 2 bf16 ulps of the larger of the two (worst at "
                  f"{share})")
            m = (want - p0).abs() > DLM_LR / 2
            same = int(((got - p0).sign() == (want - p0).sign())[m].sum())
            if not m.any():       # bf16 norms at 1.0: lr is under half an ulp
                still.append(name)
                continue
            leaf = same / int(m.sum())
            low = min(low, (leaf, name))
            check(leaf >= DLM_SIGN_SHARE,
                  f"17a {name}: update signs agree on {leaf} of "
                  f"{int(m.sum())} moved elements (>= {DLM_SIGN_SHARE})")
            moved += int(m.sum())
            agree += same
        for blk in blocks:
            blk.clear()
        print(f"  17a: every gathered gradient leaf == one rank's within "
              f"{DLM_GRAD_ULPS} bf16 ulps of its largest |grad| (worst "
              f"{worst_g[0]} ulps, {worst_g[1]}); updated parameters within "
              f"2 lr + 2 bf16 ulps (a sign flip of a near-zero gradient "
              f"moves a weight by 2 lr; worst element at {worst:.4f} of "
              f"it); update signs equal on {agree / max(moved, 1)} of "
              f"{moved} elements that moved, in every leaf at least "
              f"{low[0]} ({low[1]}); no element of {len(still)} leaves "
              f"moved ({', '.join(still)})")

        # 17b gates ---------------------------------------------------------
        toks_b = torch.load(os.path.join(tmp, "dlm_tokens.pt"),
                            weights_only=True)["b"]
        want = torch.cat(ref_b)
        worst = 0.0
        for r, rec in enumerate(recs):
            bb = rec["17b"]
            launches["17b"][r] = bb["launches"]
            check(torch.equal(bb["logits"], recs[0]["17b"]["logits"]),
                  f"17b rank {r}: the same logits as rank 0")
            check(bb["length"] == length and bb["block"][3] == s_loc,
                  f"17b rank {r}: cache block {bb['block']}, length "
                  f"{bb['length']}")
            print(f"  17b rank {r}: positions [{bb['lo']}, "
                  f"{bb['lo'] + bb['block'][3]}), block {bb['block']}, "
                  f"steps {bb['step_ms']} ms, peak {bb['peak_gb']} GB, "
                  f"launches {bb['launches']}, slots written "
                  f"{len(bb['written']['k'])} K / {len(bb['written']['v'])}"
                  f" V ({smi})")
        got = recs[0]["17b"]["logits"]
        for i in range(DLM_LONG_STEPS):
            row = want[i].abs().max()
            err = float((got[i] - want[i]).abs().max())
            worst = max(worst, err / float(row))
            check(err <= DLM_LONG_TOL * float(row),
                  f"17b step {i}: logits within {DLM_LONG_TOL} of the row's "
                  f"largest |logit| {float(row)} (max abs err {err})")
            check(int(got[i].argmax()) == int(toks_b[i + 1]),
                  f"17b step {i}: greedy token {int(got[i].argmax())} == "
                  f"one rank's {int(toks_b[i + 1])}")
        new_slots = [(layer, p) for layer in range(cfg_b.n_layers)
                     for p in range(new_pos.start, new_pos.stop)]
        worst_w = 0.0
        for w in ("k", "v"):
            found = sorted((layer, p, r) for r, rec in enumerate(recs)
                           for layer, p, _ in rec["17b"]["written"][w])
            owners = {r for _, _, r in found}
            check([(layer, p) for layer, p, _ in found] == new_slots
                  and len(owners) == 1 and all(
                      recs[r]["17b"]["lo"] <= p < recs[r]["17b"]["lo"]
                      + s_loc for _, p, r in found),
                  f"17b: the {w.upper()} slots that changed are the new "
                  f"tokens' {new_pos.start}..{new_pos.stop - 1} in every "
                  f"layer, on the one rank holding them (found "
                  f"{len(found)} on ranks {sorted(owners)})")
            for layer, p, val in recs[owners.pop()]["17b"]["written"][w]:
                ref_w = written_b[w][layer]
                err = float((val - ref_w[:, p - new_pos.start]).abs().max()
                            / ref_w.abs().max())
                worst_w = max(worst_w, err)
                check(err <= DLM_LONG_TOL,
                      f"17b: layer {layer}'s {w.upper()} at {p} within "
                      f"{DLM_LONG_TOL} of one rank's largest written value "
                      f"({err})")
        print(f"  17b: {DLM_LONG_STEPS} context-parallel steps over "
              f"{DLM_WORLD} ranks == one rank: tokens "
              f"{toks_b[1:].tolist()}, worst logit error {worst} of the "
              f"row's largest; the new tokens' K and V written on one rank "
              f"only, within {worst_w} of one rank's")

        # 17c gates ---------------------------------------------------------
        kept_sum = dropped_sum = 0
        for r, rec in enumerate(recs):
            c = rec["17c"]
            launches["17c"][r] = c["launches"]
            i = rec["coords"]["data"]
            if rec["coords"]["model"] == 0:
                kept_sum += c["kept"]
                dropped_sum += c["dropped"]
            w = ref_c[i:i + 1]
            err = float((c["logits"] - w).abs().max())
            check(err <= DLM_MOE_TOL * float(w.abs().max()),
                  f"17c rank {r}: logits of data shard {i} within "
                  f"{DLM_MOE_TOL} of the row's largest |logit| (max abs err "
                  f"{err})")
            if on_card:
                check(c["launches"]["float32"] == DLM_MOE_LAYERS,
                      f"17c rank {r}: one flash_attention launch a layer")
            print(f"  17c rank {r} {rec['coords']}: prefill "
                  f"{c['prefill_ms']} ms, peak {c['peak_gb']} GB, kept "
                  f"{c['kept']}, dropped {c['dropped']}, max abs err {err}, "
                  f"launches {c['launches']} ({smi})")
        check((kept_sum, dropped_sum) == (kept, dropped),
              f"17c: kept / dropped slots {kept_sum} / {dropped_sum} == one "
              f"rank's {kept} / {dropped}")

        # 17c in bf16: the one-rank run on its own routing, then on the
        # ranks' experts
        row = {rec["coords"]["data"]: rec["17c16"] for rec in recs
               if rec["coords"]["model"] == 0}
        for rec in recs:
            check(all(torch.equal(x, y) for x, y in zip(
                rec["17c16"]["routes"], row[rec["coords"]["data"]]["routes"]
            )), f"17c bf16: rank {rec['coords']} routes as its data shard's "
                f"model rank 0")
        ranks_routes = [torch.cat([row[i]["routes"][layer]
                                   for i in range(DLM_MESH[0])])
                        for layer in range(DLM_MOE_LAYERS)]
        own = []
        ref16, _, own_slots = moe_prefill("c16_local", DLM_SEED + 3, tok_c,
                                          routes=own)
        flips = [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                 for x, y in zip(own, ranks_routes)]
        ref16, ms16, slots16 = moe_prefill("c16_local", DLM_SEED + 3, tok_c,
                                           replay=list(ranks_routes))
        n_tok = ranks_routes[0].shape[0]
        print(f"  17c bf16 one rank: {b} x {s} prefill {ms16} ms on the "
              f"ranks' experts; on its own routing kept / dropped "
              f"{own_slots}, experts differing from the ranks' on {flips} "
              f"of {n_tok} tokens a layer ({smi})")
        for layer, f in enumerate(flips):
            check(f <= DLM_MOE_FLIP_BUDGET * n_tok,
                  f"17c bf16 layer {layer}: the routing differs from the "
                  f"ranks' on {f} of {n_tok} tokens (budget "
                  f"{DLM_MOE_FLIP_BUDGET})")
        kept16 = dropped16 = 0
        worst = 0.0
        for i, c in row.items():
            kept16 += c["kept"]
            dropped16 += c["dropped"]
            ulps = _bf16_ulps(c["logits"], ref16[i:i + 1])
            worst = max(worst, ulps)
            check(ulps <= DLM_MOE_BF16_ULPS,
                  f"17c bf16 data shard {i}: logits within "
                  f"{DLM_MOE_BF16_ULPS} bf16 ulps of the row's largest "
                  f"|logit| ({ulps})")
        for r, rec in enumerate(recs):
            c = rec["17c16"]
            launches["17c16"][r] = c["launches"]
            if on_card:
                check(c["launches"]["bfloat16"] == DLM_MOE_LAYERS,
                      f"17c bf16 rank {r}: one flash_attention launch a "
                      f"layer")
            print(f"  17c bf16 rank {r} {rec['coords']}: prefill "
                  f"{c['prefill_ms']} ms, peak {c['peak_gb']} GB, kept "
                  f"{c['kept']}, dropped {c['dropped']}, launches "
                  f"{c['launches']} ({smi})")
        check((kept16, dropped16) == slots16,
              f"17c bf16: kept / dropped slots {kept16} / {dropped16} == one"
              f" rank's on the same experts {slots16}")
        print(f"  17c bf16: logits == one rank's on the same experts within "
              f"{worst} bf16 ulps of the row's largest (<= "
              f"{DLM_MOE_BF16_ULPS})")
        phase("17 gates", t0)

        # 17d: the example twins on gloo ranks sharing the card -----------
        t0 = time.perf_counter()
        sys.path.insert(0, os.path.join(os.path.dirname(_src_path()),
                                        "examples"))
        import graph_cc_torch
        import quickstart_torch
        for k in kmod.launches:
            kmod.launches[k] = 0
        argv = ["--ranks", str(DLM_EXAMPLE_RANKS), "--device", dev.type]
        quickstart_torch.main(argv)
        graph_cc_torch.main(argv)
        fused = dict(kmod.launches)
        check(not on_card or sum(fused.values()) >= 1,
              "17d: the twins' single-device parts launched the fused kernel")
        print(f"  17d: both twins' assertions hold on {DLM_EXAMPLE_RANKS} "
              f"gloo ranks; fused launches in this process {fused}")
        phase("17d example twins", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, fused, attn_err


def _launch_predictions(out, smoke):
    """Phase 18b's dry runs and 18a's pod-axis rule, in a process of their
    own (fake process groups, the meta device): rank 0's memory record of
    the one-rank llama3.2-1b train_4k cell at LAUNCH_LM_BATCH and of the
    dpc_grid grid_512 cell, and the per-rank argument bytes of kimi_k2_1t
    and stablelm_12b train_4k on both production meshes.  Written to
    `out`/predictions.json."""
    import torch
    sys.path.insert(0, _src_path())
    from repro_torch import _meta, configs
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.meshctx import Mesh
    rec = {"args": {}}
    with dryrun.fake_world(1):
        mesh = Mesh((1, 1), ("data", "model"), "meta")
        b, s = (2, 64) if smoke else LAUNCH_LM_BATCH
        cell = cells.build_lm_cell(
            "llama3_2_1b", configs.get("llama3_2_1b"), "train_4k",
            {"kind": "train", "batch": b, "seq": s}, mesh, smoke)
        rec["lm"] = dryrun.trace_cell(cell)[:2]
        cell = cells.build_cell("dpc_grid", "grid_512", mesh, smoke=smoke)
        rec["dpc"] = dryrun.trace_cell(cell)[:2]
    for label, (multi_pod, size) in dryrun.MESHES.items():
        with dryrun.fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            for arch in ("kimi_k2_1t", "stablelm_12b"):
                cell = cells.build_cell(arch, "train_4k", mesh, smoke=smoke)
                rec["args"][f"{arch}@{label}"] = sum(
                    _meta.nbytes(t) for t in torch.utils._pytree.tree_leaves(
                        cell.local(cell.arg_shapes))
                    if isinstance(t, torch.Tensor))
    with open(os.path.join(out, "predictions.json"), "w") as f:
        json.dump(rec, f)


def _launch_rank(rank, store, tmp, device, smoke):
    """Phase 18c-d's ranks on mesh LAUNCH_MESH: BST's serve_bulk forward
    and retrieval (the bag launches counted), MeshGraphNet's forward,
    loss, gradients and one AdamW step, GAT minibatch_lg's forward, loss
    and gradients, each on this rank's blocks; records to
    `tmp`/launch_rank<r>.pt."""
    import torch
    from repro_torch import configs
    from repro_torch.interop import gnn_batch_from_numpy
    from repro_torch.kernels import segment_bag as bag_mod
    from repro_torch.models import bst, gnn
    from repro_torch.runtime.meshctx import Mesh, use_mesh
    from repro_torch.tree import tree_map

    _rank_setup(rank, LAUNCH_WORLD, store, "gloo", device)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mesh = Mesh(LAUNCH_MESH, ("data", "model"), dev)
    inp = torch.load(os.path.join(tmp, "launch_inputs.pt"),
                     weights_only=False)
    out = {"coords": mesh.coords}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # 18c: BST
    cfg = getattr(configs.get("bst"), "smoke_config" if smoke
                  else "full_config")()
    params = bst.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    local = bst.shard_params(params, cfg, mesh)
    del params
    batch = {k: mesh.block(v.to(dev), ("data",), 0)
             for k, v in inp["bst_batch"].items()}
    retr = {k: v.to(dev) for k, v in inp["bst_retrieval"].items()}
    retr["candidates"] = mesh.block(retr["candidates"], ("data",), 1)
    with use_mesh(mesh), torch.no_grad():
        bst.forward(local, batch, cfg)                      # warm-up
        sync()
        for k in bag_mod.launches:
            bag_mod.launches[k] = 0
        t = time.perf_counter()
        logits = bst.forward(local, batch, cfg)
        sync()
        out["bst_ms"] = (time.perf_counter() - t) * 1e3
        out["bst_launches"] = dict(bag_mod.launches)
        out["bst_logits"] = mesh.gather(logits, ("data",), 0).cpu()
        t = time.perf_counter()
        vals, ids = bst.retrieval_step(local, retr, cfg, top_k=100)
        sync()
        out["retrieval_ms"] = (time.perf_counter() - t) * 1e3
    out["retrieval"] = (vals.cpu(), ids.cpu())
    del local, batch, retr, logits
    # 18d: MeshGraphNet forward and one AdamW step, GAT minibatch_lg
    for key, arch in (("mgn", "meshgraphnet"), ("gat", "gat_cora")):
        cfg = inp[f"{key}_cfg"]
        params = tree_map(lambda t: t.to(dev), inp[f"{key}_params"])
        graph = gnn.shard_batch(gnn_batch_from_numpy(inp[f"{key}_graph"],
                                                     dev), mesh)
        with use_mesh(mesh):
            with torch.no_grad():
                t = time.perf_counter()
                y = gnn.apply(params, graph, cfg)
                sync()
                out[f"{key}_fwd_ms"] = (time.perf_counter() - t) * 1e3
                out[f"{key}_out"] = mesh.gather(y, mesh.axis_names, 0).cpu()
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            t = time.perf_counter()
            loss, _ = gnn.loss_fn(leaves, graph, cfg)
            loss.backward()
            grads = tree_map(lambda t: t.grad, leaves)
            if key == "mgn":
                new = _gnn_adamw_step(params, grads)
            sync()
            out[f"{key}_step_ms"] = (time.perf_counter() - t) * 1e3
        if key == "mgn":
            out["mgn_new"] = tree_map(lambda t: t.cpu(), new)
            del new
        out[f"{key}_loss"] = float(loss.detach())
        out[f"{key}_grads"] = tree_map(lambda t: t.cpu(), grads)
        out[f"{key}_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                 if on_card else None)
        del params, graph, leaves, grads, loss, y
    torch.save(out, os.path.join(tmp, f"launch_rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


def _gnn_adamw_step(params, grads):
    """18d's one AdamW step from a fresh state: the new parameters."""
    from repro_torch.optim import adamw
    opt = adamw(GNN_LR, weight_decay=0.01)
    return opt.update(grads, opt.init(params), params)[0]


def _step_agree(got, want, lr):
    """(max |got - want| over the leaves, the share of elements whose
    update differs by more than lr: a flipped sign moves one by 2 lr)."""
    from repro_torch.tree import tree_leaves
    diffs = [(a.float() - b.float()).abs()
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return (max(float(d.max()) for d in diffs),
            sum(int((d > lr).sum()) for d in diffs)
            / sum(d.numel() for d in diffs))


def _leafwise_err(got, want):
    """max over leaves of max |got - want| / max |want|."""
    import torch
    from repro_torch.tree import tree_leaves
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def launch_path(smi, dev, minibatch, smoke=False):
    """Phase 18: the launch tools and the sharded BST and GNNs.  18a: JAX's
    six dry-run test cells (LAUNCH_CELLS) at full configs on their meshes,
    each through `python -m repro_torch.launch.dryrun` in a process of its
    own (a fake process group of 256 or 512 ranks, rank 0's step on the
    meta device), all at once: per-rank GiB (args + temp), GFLOP and
    collective MiB; and JAX's pod-axis rule (the per-rank argument bytes
    of kimi_k2_1t and stablelm_12b train_4k on 2 x 256 no larger than on
    256).  18b: on a one-rank mesh, the llama3.2-1b train_4k cell at
    LAUNCH_LM_BATCH and the dpc_grid grid_512 cell (a one-rank NCCL
    group), each step on the card with all five kernels' counts set to 0
    just before it and read just after, the dry run's args + temp
    (predicted in another process) beside the measured peak, within
    LAUNCH_LM_MEM_TOL / LAUNCH_DPC_MEM_MAX.  18c-d:
    LAUNCH_WORLD gloo ranks sharing the card on mesh LAUNCH_MESH: BST's
    full config at serve_bulk (logits == one rank's within BST_LOGIT_TOL,
    the bag kernel launched on every rank) and its retrieval of 10^6
    candidates (top-100 ids == one rank's); MeshGraphNet 512^2 (forward
    == one rank within GNN_FWD_TOL of the largest output; the loss, the
    gradients and one AdamW step's parameters) and GAT minibatch_lg
    (phase 16's sampled batch: forward, loss and gradients).  `minibatch` is phase 16's host batch; `smoke` runs
    the smoke configs (a CPU rehearsal, nothing timed).  Returns the
    launches by sub-phase."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch import configs
    from repro_torch.configs import gnn_shapes
    from repro_torch.core.ids import compute_order
    from repro_torch.data import graphs, perlin_noise, recsys
    from repro_torch.interop import gnn_batch_from_numpy
    from repro_torch.kernels import (block_pathcompress, flash_attention,
                                     fused_local_phase, segment_bag,
                                     steepest_neighbor)
    from repro_torch.launch import cells
    from repro_torch.models import bst, gnn, lm
    from repro_torch.runtime.meshctx import Mesh
    from repro_torch.tree import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    launches = {}
    kernel_mods = {"steepest_neighbor": steepest_neighbor,
                   "block_pathcompress": block_pathcompress,
                   "segment_bag": segment_bag,
                   "flash_attention": flash_attention,
                   "fused_local_phase": fused_local_phase}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    try:
        # 18a: the dry runs, each in its own process, all at once --------
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=_src_path())
        procs = []
        for arch, shape, flag in LAUNCH_CELLS:
            log = open(os.path.join(tmp, f"{arch}__{shape}.log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, flag, "--out",
                   os.path.join(tmp, "dryrun")] + (["--smoke"] if smoke
                                                   else [])
            procs.append((arch, shape, log, subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
        plog = open(os.path.join(tmp, "predictions.log"), "w")
        pred = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             f"{root!r}); import chip_smoke; chip_smoke._launch_predictions("
             f"{tmp!r}, {smoke!r})"], env=env, stdout=plog,
            stderr=subprocess.STDOUT)

        # 18b: the two one-rank cells on the card, meanwhile -------------
        t1 = time.perf_counter()
        mesh1 = Mesh((1, 1), ("data", "model"), dev)
        b, s = (2, 64) if smoke else LAUNCH_LM_BATCH
        cell = cells.build_lm_cell(
            "llama3_2_1b", configs.get("llama3_2_1b"), "train_4k",
            {"kind": "train", "batch": b, "seq": s}, mesh1, smoke)
        gen = torch.Generator(device=dev).manual_seed(LAUNCH_SEED)
        params = lm.init_params(gen, cell.cfg)
        toks = torch.randint(0, cell.cfg.vocab, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)
        args = ((params, cell.opt.init(params)),
                {"tokens": toks, "labels": toks})
        measured = {}

        def measure(name, *step_args):
            sync()
            if on_card:
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated() - nbytes(step_args)
                torch.cuda.reset_peak_memory_stats()
            for mod in kernel_mods.values():
                for k in mod.launches:
                    mod.launches[k] = 0
            t = time.perf_counter()
            result = cell.step_fn(*step_args)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            launches[f"18b {name}"] = {
                mname: dict(mod.launches)
                for mname, mod in kernel_mods.items()}
            peak = (torch.cuda.max_memory_allocated() - base) if on_card \
                else None
            measured[name] = {"peak": peak, "ms": ms,
                              "args": nbytes(step_args)}
            return result

        (new, _), metrics = measure("lm", *args)
        check(bool(torch.isfinite(metrics["loss"])),
              f"18b lm: the step's loss is finite ({float(metrics['loss'])})")
        lm_launch = launches["18b lm"]["flash_attention"]
        check(not on_card or sum(lm_launch.values()) == 2 * cell.cfg.n_layers,
              f"18b lm: the attention kernel launched twice a layer (remat),"
              f" {lm_launch}")
        del new, args, params, metrics
        store = os.path.join(tmp, "store_18b")
        dist.init_process_group("nccl" if on_card else "gloo",
                                store=dist.FileStore(store, 1), rank=0,
                                world_size=1)
        try:
            cell = cells.build_cell("dpc_grid", "grid_512", mesh1,
                                    smoke=smoke)
            dims = tuple(cell.arg_shapes[0].shape)
            order = compute_order(perlin_noise(dims, frequency=0.1,
                                               seed=SEED, device=dev))
            labels, stats = measure("dpc", *cell.local((order,)))
            check(tuple(labels.shape) == dims and bool((labels >= 0).all())
                  and int(stats.converged) == 1,
                  f"18b dpc: labels of {dims}, all maxima ids, converged")
            del order, labels
        finally:
            dist.destroy_process_group()
        phase("launch 18b: one-rank cells on the card", t1)

        rcs = {}
        for arch, shape, log, p in procs:
            rcs[(arch, shape)] = p.wait(timeout=900)
            log.close()
        pred.wait(timeout=900)
        plog.close()
        with open(os.path.join(tmp, "predictions.log")) as f:
            text = f.read()
        check(pred.returncode == 0, f"18b predictions exit 0: "
              f"{text[-2000:]}")
        for (arch, shape), rc in rcs.items():
            with open(os.path.join(tmp, f"{arch}__{shape}.log")) as f:
                text = f.read()
            check(rc == 0 and "0 failures" in text,
                  f"18a {arch}:{shape} dry run exit 0: {text[-3000:]}")
        for arch, shape, flag in LAUNCH_CELLS:
            label = "pod256" if flag == "--single-pod" else "pod2x256"
            with open(os.path.join(tmp, "dryrun", label,
                                   f"{arch}__{shape}.json")) as f:
                rec = json.load(f)
            m = rec["memory"]
            check(rec["cost"]["flops"] > 0 and m["argument_size_in_bytes"]
                  > 0, f"18a {arch}:{shape}: flops and arguments counted")
            print(f"  18a {rec['cell']} @ {label}: per rank "
                  f"{(m['argument_size_in_bytes'] + m['temp_size_in_bytes']) / 2**30:.3f}"
                  f" GiB (args {m['argument_size_in_bytes'] / 2**30:.3f}, "
                  f"temp {m['temp_size_in_bytes'] / 2**30:.3f}), "
                  f"{rec['cost']['flops'] / 1e9:.1f} GFLOP, "
                  f"{rec['cost']['bytes accessed'] / 1e9:.2f} GB accessed, "
                  f"collectives {rec['collectives']['total'] / 2**20:.1f} MiB"
                  f" in {rec['collectives']['n_collectives']}, traced in "
                  f"{rec['compile_s']} s; kernels {rec['kernels']}; "
                  f"{rec['note']}")
        with open(os.path.join(tmp, "predictions.json")) as f:
            pred_rec = json.load(f)
        for arch in ("kimi_k2_1t", "stablelm_12b"):
            a, b2 = (pred_rec["args"][f"{arch}@{m}"]
                     for m in ("pod256", "pod2x256"))
            check(b2 <= a, f"18a {arch} train_4k: per-rank arguments on "
                  f"2 x 256 ({b2} B) no larger than on 256 ({a} B)")
            print(f"  18a {arch} train_4k arguments a rank: {a} B on 256, "
                  f"{b2} B on 2 x 256")
        phase("launch 18a: dry runs", t0)
        for name in ("lm", "dpc"):
            mem = pred_rec[name][0]
            want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            got = measured[name]
            print(f"  18b {name}: dry run args {mem['argument_size_in_bytes']}"
                  f" + temp {mem['temp_size_in_bytes']} = {want} B "
                  f"({want / 1e9:.3f} GB), card peak over the step "
                  f"{got['peak']} B (args {got['args']}), step "
                  f"{got['ms']:.3f} ms, launches {launches['18b ' + name]} "
                  f"({smi})")
            check(mem["argument_size_in_bytes"] == got["args"],
                  f"18b {name}: the dry run's arguments == the card's "
                  f"({mem['argument_size_in_bytes']} vs {got['args']})")
            if on_card:
                ratio = want / got["peak"]
                print(f"  18b {name}: predicted / measured = {ratio:.4f}")
                if name == "lm":
                    check(abs(ratio - 1) <= LAUNCH_LM_MEM_TOL,
                          f"18b lm: the dry run's memory within "
                          f"{LAUNCH_LM_MEM_TOL} of the card's peak "
                          f"({ratio})")
                else:
                    check(1.0 <= ratio <= LAUNCH_DPC_MEM_MAX,
                          f"18b dpc: the dry run's memory bounds the card's "
                          f"peak, at most {LAUNCH_DPC_MEM_MAX}x ({ratio})")

        # 18c-d: the one-rank references, then the ranks ------------------
        t0 = time.perf_counter()
        bmod = configs.get("bst")
        bcfg = bmod.smoke_config() if smoke else bmod.full_config()
        bshapes = bmod.SMOKE_SHAPES if smoke else bmod.SHAPES
        bbatch = {k: torch.from_numpy(v) for k, v in recsys.bst_batch(
            bcfg, bshapes["serve_bulk"]["batch"], LAUNCH_SEED).items()}
        bretr = {k: torch.from_numpy(v) for k, v in recsys.retrieval_batch(
            bcfg, 1, bshapes["retrieval_cand"]["n_candidates"],
            LAUNCH_SEED).items()}
        params = bst.init_params(torch.Generator(device=dev).manual_seed(0),
                                 bcfg)
        with torch.no_grad():
            ref_logits = bst.forward(params, {k: v.to(dev) for k, v in
                                              bbatch.items()}, bcfg).cpu()
            ref_retr = [t.cpu() for t in bst.retrieval_step(
                params, {k: v.to(dev) for k, v in bretr.items()}, bcfg,
                top_k=100)]
        del params
        side = 16 if smoke else GNN_MESH_SIDE
        make = "smoke_config" if smoke else "full_config"
        mcfg = getattr(configs.get("meshgraphnet"), make)()
        mgraph = graphs.pad_graph(graphs.mesh_grid_graph(side, side, seed=0),
                                  LAUNCH_WORLD)
        gcfg = dataclasses.replace(
            getattr(configs.get("gat-cora"), make)(),
            d_in=minibatch["node_feat"].shape[1],
            n_classes=int(minibatch["labels"].max()) + 1 if smoke else
            gnn_shapes.SHAPES["minibatch_lg"]["n_classes"])
        ggraph = graphs.pad_graph(minibatch, LAUNCH_WORLD)
        refs = {}
        inputs = {"bst_batch": bbatch, "bst_retrieval": bretr}
        for key, cfg, host in (("mgn", mcfg, mgraph), ("gat", gcfg, ggraph)):
            params = gnn.init_params(torch.Generator().manual_seed(GNN_SEED),
                                     cfg)
            card = tree_map(lambda t: t.to(dev), params)
            graph = gnn_batch_from_numpy(host, dev)
            with torch.no_grad():
                y = gnn.apply(card, graph, cfg).cpu()
            leaves = tree_map(lambda t: t.detach().requires_grad_(), card)
            loss, _ = gnn.loss_fn(leaves, graph, cfg)
            loss.backward()
            grads = tree_map(lambda t: t.grad, leaves)
            refs[key] = (y, float(loss.detach()),
                         tree_map(lambda t: t.cpu(), grads),
                         tree_map(lambda t: t.cpu(), _gnn_adamw_step(
                             card, grads)) if key == "mgn" else None)
            inputs.update({f"{key}_cfg": cfg, f"{key}_params": params,
                           f"{key}_graph": host})
            del card, graph, leaves, grads, loss
        torch.save(inputs, os.path.join(tmp, "launch_inputs.pt"))
        del inputs
        if on_card:
            torch.cuda.empty_cache()
        phase("launch 18c-d: one-rank references", t0)

        t0 = time.perf_counter()
        mp.spawn(_launch_rank, args=(os.path.join(tmp, "store_18"), tmp,
                                     dev.type, smoke), nprocs=LAUNCH_WORLD)
        recs = [torch.load(os.path.join(tmp, f"launch_rank{r}.pt"),
                           weights_only=False) for r in range(LAUNCH_WORLD)]
        phase("launch 18c-d: ranks", t0)
        launches["18c"] = {r: rec["bst_launches"] for r, rec in
                           enumerate(recs)}
        top = float(ref_logits.abs().max())
        for r, rec in enumerate(recs):
            err = float((rec["bst_logits"] - ref_logits).abs().max())
            check(err <= BST_LOGIT_TOL[1] * max(top, 1.0),
                  f"18c rank {r}: serve_bulk logits == one rank's within "
                  f"{BST_LOGIT_TOL[1]} of {top} (err {err})")
            check(not on_card or sum(rec["bst_launches"].values()) == 2,
                  f"18c rank {r}: segment_bag launched on this rank's rows "
                  f"({rec['bst_launches']})")
            check(torch.equal(rec["retrieval"][1], ref_retr[1]),
                  f"18c rank {r}: top-100 retrieval ids == one rank's")
            print(f"  18c rank {r} {rec['coords']}: serve_bulk forward "
                  f"{rec['bst_ms']:.3f} ms (err {err}, launches "
                  f"{rec['bst_launches']}), retrieval {rec['retrieval_ms']:.3f}"
                  f" ms, ids == one rank's ({smi})")
        for key, label in (("mgn", "18d MeshGraphNet"),
                           ("gat", "18d GAT minibatch_lg")):
            y, loss, grads, new = refs[key]
            top = float(y.abs().max())
            for r, rec in enumerate(recs):
                err = float((rec[f"{key}_out"] - y).abs().max())
                gerr = _leafwise_err(rec[f"{key}_grads"], grads)
                check(err <= GNN_FWD_TOL * top,
                      f"{label} rank {r}: forward == one rank's within "
                      f"{GNN_FWD_TOL} of {top} (err {err})")
                check(abs(rec[f"{key}_loss"] - loss) <= GNN_FWD_TOL
                      * max(abs(loss), 1.0) and gerr <= LAUNCH_GRAD_TOL,
                      f"{label} rank {r}: loss {rec[f'{key}_loss']} vs "
                      f"{loss}, gradients within {gerr} of each leaf's "
                      f"largest (<= {LAUNCH_GRAD_TOL})")
                step = ""
                if new is not None:
                    perr, flips = _step_agree(rec["mgn_new"], new, GNN_LR)
                    check(perr <= 2 * GNN_LR and flips <= LAUNCH_FLIP_SHARE,
                          f"{label} rank {r}: the AdamW step's parameters "
                          f"within 2 lr of one rank's ({perr}), updates "
                          f"flipped on {flips} <= {LAUNCH_FLIP_SHARE}")
                    step = (f", AdamW parameters within {perr} of one "
                            f"rank's, {flips} of the updates flipped")
                print(f"  {label} rank {r} {rec['coords']}: forward "
                      f"{rec[f'{key}_fwd_ms']:.3f} ms (err {err} of {top}), "
                      f"loss + backward{' + AdamW' if key == 'mgn' else ''} "
                      f"{rec[f'{key}_step_ms']:.3f} ms, gradients {gerr}"
                      f"{step}, peak {rec[f'{key}_peak_gb']} GB ({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    sys.path.insert(0, _src_path())
    from repro_torch.configs.dpc_grid import SHAPES, full_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_local_phase as kmod
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.ids import compute_order
    from repro_torch.core.ms_segmentation import ms_segmentation, extrema
    from repro_torch.data import chains, perlin_noise, quantile
    from repro_torch.topology import TopologyRequest, submit

    dev = torch.device("cuda")
    numbers = {}
    # the configs' grid_512 (ms) and cc_512 (cc of the top-10% mask)
    cfg = full_config()
    shape = SHAPES["grid_512"]["dims"]
    check(SHAPES["cc_512"]["dims"] == shape, "grid_512 and cc_512 match")
    conn, q = cfg.connectivity, cfg.threshold_quantile

    # 1. device ------------------------------------------------------------
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {name}, capability {cap}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    check(cap >= (9, 0), f"compute capability {cap} >= (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase("device", t0)

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    for kname in paths:
        for line in _build.build_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname}: {line.strip()}")
    numbers["build_s"] = time.perf_counter() - t0
    phase("build", t0)

    # 3. kernel vs plain on the card ----------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {"manifold": 0, "cc": 0}
    rounds = {}

    def compare(field, c, mode, smask, block_x, id_dtype=None):
        if isinstance(id_dtype, str):
            id_dtype = getattr(torch, id_dtype)
        got, r = kmod.fused_local_phase(field, c, mode=mode,
                                        self_mask=smask, block_x=block_x,
                                        id_dtype=id_dtype)
        want, wr = ref.fused_local_phase_ref(field, c, mode=mode,
                                             self_mask=smask,
                                             block_x=block_x,
                                             id_dtype=id_dtype)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err[mode] = max(err[mode], e)
        check(got.dtype == want.dtype and e == 0 and r == wr,
              f"kernel == plain: {mode} conn {c} block_x {block_x} "
              f"self_mask {smask is not None} ids {got.dtype} "
              f"(max err {e}, rounds {r} vs {wr})")
        return r

    def fields(shape):
        n = int(np.prod(shape))
        order = torch.randperm(n, generator=gen, device=dev).to(
            torch.int32).reshape(shape)
        mask = torch.rand(shape, generator=gen, device=dev) < 0.6
        smask = torch.rand(shape, generator=gen, device=dev) < 0.2
        return {"manifold": order, "cc": mask}, smask

    fld, smask = fields(RAGGED)
    n_cases = 0
    for mode in ("manifold", "cc"):
        for c in (6, 14, 18, 26):     # not `conn`: that is the main path's
            for sm in (None, smask):
                for block_x in (1, 8):
                    compare(fld[mode], c, mode, sm, block_x)
                    n_cases += 1
    fld, smask = fields((33, 17, 19))
    for mode in ("manifold", "cc"):
        compare(fld[mode], 14, mode, smask, 4, id_dtype=torch.int64)
        n_cases += 1
    print(f"  {n_cases} ragged/int64 cases: kernel == plain (tolerance 0: "
          "pointers and rounds exactly equal)")
    # long chains in one slab (repro_torch.data.chains), both directions of
    # the ids (flipped along y and z), at slab sizes of the main path
    for make, flip, shp, mode, block_x, id_dtype in LONG_CHAINS:
        f = getattr(chains, make)(shp, device=dev)
        f = (f.flip((1, 2)) if flip else f).contiguous()
        r = compare(f, 6, mode, None, block_x, id_dtype)
        print(f"  {make} {shp}{' flipped' if flip else ''} block_x "
              f"{block_x}: kernel == plain, {r} rounds")
        del f

    field = perlin_noise(shape, frequency=0.1, seed=SEED)
    # the field's float64 sum tells two runs' inputs apart
    numbers["field_sum"] = float(field.double().sum())
    print(f"  grid_512 Perlin field: float64 sum {numbers['field_sum']!r}")
    big = {"manifold": compute_order(field)}
    big["cc"] = field > quantile(field, q)
    del field
    for mode in ("manifold", "cc"):
        rounds[mode] = compare(big[mode], conn, mode, None, 8)
        print(f"  grid_512 {mode}, connectivity {conn}: kernel == plain, "
              f"{rounds[mode]} rounds")
    phase("kernel vs plain", t0)

    # 4. main path at 512^3 through the facade --------------------------------
    t0 = time.perf_counter()
    for mode in kmod.launches:
        kmod.launches[mode] = 0
    torch.cuda.reset_peak_memory_stats()
    field = perlin_noise(shape, frequency=0.1, seed=SEED)
    order = compute_order(field)
    ms = submit(TopologyRequest("ms", order=order, connectivity=conn))
    thr = quantile(field, q)
    mask = field > thr
    del field
    cc = submit(TopologyRequest("cc", mask=mask, connectivity=conn))
    torch.cuda.synchronize()
    launches = dict(kmod.launches)
    numbers["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  kernel launches on the main path: {launches}")
    check(launches["manifold"] >= 2 and launches["cc"] >= 1
          and sum(launches.values()) >= 3, "main path launched the kernel")
    check(torch.equal(order, big["manifold"])
          and torch.equal(mask, big["cc"]), "the main path's inputs are the "
          "ones compared in phase 3")
    del big
    for t, what in ((ms.ascending, "ms.ascending"),
                    (ms.descending, "ms.descending"),
                    (ms.segmentation, "ms.segmentation"),
                    (cc.labels, "cc.labels")):
        check(tuple(t.shape) == shape and t.dtype == torch.int32
              and t.is_cuda, f"{what} is an int32 {shape} CUDA tensor")
    numbers.update(threshold=float(thr), masked=int(mask.sum()), **ms.meta,
                   **cc.meta)
    phase("main path", t0)

    # 5. checks that do not trust the kernel ---------------------------------
    t0 = time.perf_counter()
    n = order.numel()
    ms_ref = ms_segmentation(order, conn, fused_impl="ref")
    for k in ("ascending", "descending", "segmentation"):
        check(torch.equal(getattr(ms_ref, k), getattr(ms, k)),
              f"ms {k} == the init-only plain path")
    cc_ref = connected_components_grid(mask, conn, fused_impl="ref")
    check(torch.equal(cc_ref.labels, cc.labels),
          "cc labels == the init-only plain path")
    numbers.update(ref_n_iter_desc=ms_ref.n_iter_desc,
                   ref_n_iter_asc=ms_ref.n_iter_asc,
                   ref_n_compress_iter=cc_ref.n_compress_iter)
    del ms_ref, cc_ref

    import scipy.ndimage as ndi
    check(conn == 6, "scipy's face-connected structure is connectivity 6")
    lab, n_comp = ndi.label(mask.cpu().numpy(),
                            structure=ndi.generate_binary_structure(3, 1))
    lab = torch.from_numpy(lab.reshape(-1)).to(dev).long()
    ids = torch.arange(n, device=dev)
    top = torch.full((n_comp + 1,), -1, dtype=torch.int64, device=dev)
    top.scatter_reduce_(0, lab, ids, "amax")      # max flat id per component
    want = torch.where(lab > 0, top[lab], -1).to(torch.int32)
    n_bad = int((want != cc.labels.reshape(-1)).sum())
    check(n_bad == 0, f"cc labels == scipy.ndimage.label relabelled to max "
          f"flat id ({n_bad} voxels differ; {n_comp} scipy components, "
          f"{cc.meta['n_rounds']} stitch rounds, mask of "
          f"{int(mask.sum())} voxels)")
    del lab, ids, top, want

    maxima, minima = extrema(order, conn)
    desc, asc = ms.descending.reshape(-1), ms.ascending.reshape(-1)
    check(bool(maxima.reshape(-1)[desc.long()].all()),
          "every descending label is a maximum")
    check(bool(minima.reshape(-1)[asc.long()].all()),
          "every ascending label is a minimum")
    n_max, n_min = int(maxima.sum()), int(minima.sum())
    check(torch.unique(desc).numel() == n_max
          and torch.unique(asc).numel() == n_min,
          "one descending/ascending label per maximum/minimum")
    pair = desc.long() * n + asc.long()
    numbers.update(maxima=n_max, minima=n_min, components=int(n_comp),
                   segments=torch.unique(pair).numel(),
                   segments_by_int32_hash=torch.unique(
                       ms.segmentation).numel())
    del maxima, minima, pair
    phase("checks", t0)

    # 6. numbers -----------------------------------------------------------
    t0 = time.perf_counter()
    ms_query = lambda: submit(TopologyRequest("ms", order=order,  # noqa: E731
                                              connectivity=conn))
    cc_query = lambda: submit(TopologyRequest("cc", mask=mask,  # noqa: E731
                                              connectivity=conn))
    numbers["ms_query_ms"] = event_ms(ms_query, 3)
    numbers["cc_query_ms"] = event_ms(cc_query, 3)
    inputs = {"manifold": order, "cc": mask}
    bytes_per_voxel = {"manifold": 4 + 4, "cc": 1 + 4}
    kernels = []
    for mode in ("manifold", "cc"):
        f = inputs[mode]
        kernel_ms = event_ms(
            lambda: kmod.fused_local_phase(f, conn, mode=mode), 5)
        plain_ms = event_ms(
            lambda: ref.fused_local_phase_ref(f, conn, mode=mode), 3)
        by_bytes = n * bytes_per_voxel[mode] / HBM_BYTES_PER_S * 1e3
        by_ops = n * (conn + 1) / INT_OPS_PER_S * 1e3   # one compare each
        # device-to-host copies in the profile of one launch (the round
        # count read back); a profiler window can see no device activity
        # (PERF.md section 7), so up to three windows are taken, and with
        # none the count is not measured and the check fails
        for _ in range(3):
            rows = profile(
                lambda: kmod.fused_local_phase(f, conn, mode=mode),
                f"kernel, {mode}")
            if rows:
                break
        d2h = (sum(count for key, _, count in rows if "DtoH" in key)
               if rows else None)
        kernels.append({
            "name": f"fused_local_phase/{mode}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_local_phase.cu",
            "replaces": "src/repro/kernels/fused_local_phase.py:212",
            "launches": launches[mode], "max_abs_err": err[mode],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "rounds_512": rounds[mode],
            "device_to_host_copies_per_launch": d2h})
        print(f"  fused_local_phase/{mode}: kernel {kernel_ms:.3f} ms "
              f"({rounds[mode]} rounds), plain {plain_ms:.3f} ms, "
              f"bound {max(by_bytes, by_ops):.3f} ms, {d2h} device-to-host "
              f"copies in one launch ({smi})")
        print(f"  fused_local_phase/{mode}: previous design "
              f"{EARLIER_RUN_MS[mode]} ms, from an earlier run (PERF.md, "
              f"run R), not measured here")
        check(d2h == 1, f"one launch reads one value back (device-to-host "
              f"copies seen: {d2h})")
    profile(ms_query, "ms query")
    profile(cc_query, "cc query")
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    phase("numbers", t0)

    # 7. the four stand-alone kernels behind repro_torch.kernels.ops --------
    kernels += standalone_kernels(order, conn, smi)

    # 8. the graph domain ---------------------------------------------------
    # phase 9 holds the distributed path to these pure results: kept on the
    # host, so that phase 8's device memory is what it was without them
    host = {"order": order.cpu(), "mask": mask.cpu(),
            "segmentation": ms.segmentation.cpu(),
            "descending": ms.descending.cpu(),
            "ascending": ms.ascending.cpu(), "labels": cc.labels.cpu(),
            "ms_query_ms": numbers["ms_query_ms"],
            "cc_query_ms": numbers["cc_query_ms"]}
    del order, mask, ms, cc, inputs, f, desc, asc
    dist_graph_in = graph_path(smi, dev)[1]

    # 9. the distributed grid backend ---------------------------------------
    dist_launches, dist_fused = distributed_path(smi, host, conn, q, dev)

    # 10. the distributed graph backend -------------------------------------
    dist_launches.update(distributed_graph_path(smi, dist_graph_in, dev))
    del dist_graph_in

    # 11. the serving engine ------------------------------------------------
    serve_launches, serve_fused = serve_path(smi, host, conn, dev)
    del host
    dist_fused.update({f"serve {k}": v for k, v in serve_fused.items()})
    for row in kernels[:2]:
        mode = row["name"].split("/")[1]
        row["launches_distributed"] = {k: v[mode]
                                       for k, v in dist_launches.items()}
        row["launches_serve"] = {k: v[mode]
                                 for k, v in serve_launches.items()}
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            v[mode][0] for v in dist_fused.values() if mode in v])

    # 12. LM serving, 13. BST serving, and the launcher's topology mode --
    lm_launches, lm_err = lm_path(smi, dev)
    bst_launches, bst_err = bst_path(smi, dev)
    launcher_topology(dev)

    # 14. MoE serving, 15. training ----------------------------------------
    moe_launches, moe_err = moe_path(smi, dev)
    gradient_checks(smi, dev)
    train_launches = train_path(smi, dev)

    # 16. the GNN substrate ------------------------------------------------
    gnn_launches, minibatch = gnn_path(smi, dev)

    # 17. the distributed LM and the example twins ---------------------------
    dlm_launches, dlm_fused, dlm_err = distributed_lm_path(smi, dev)

    # 18. the launch tools, the sharded BST and GNNs -------------------------
    launch_launches = launch_path(smi, dev, minibatch)
    del minibatch
    for row in kernels:
        if row["name"] == "flash_attention/bfloat16":
            row["launches_lm"] = {k: v["bfloat16"]
                                  for k, v in lm_launches.items()}
            row["launches_moe"] = {k: v["bfloat16"]
                                   for k, v in moe_launches.items()}
            row["launches_train"] = {k: train_launches[k]["bfloat16"]
                                     for k in ("15b", "15d")}
            row["max_abs_err"] = max(row["max_abs_err"], lm_err, moe_err)
        if row["name"] == "flash_attention/float32":
            row["launches_train"] = {"15c": train_launches["15c"]["float32"]}
        if row["name"] == "segment_bag/float32":
            row["launches_bst"] = {k: v["float32"]
                                   for k, v in bst_launches.items()}
            row["launches_train"] = {"15e": train_launches["15e"]["float32"]}
            row["max_abs_err"] = max(row["max_abs_err"], bst_err)
        mod, _, key = row["name"].partition("/")
        counts = gnn_launches[mod]
        row["launches_gnn"] = counts[key] if key else sum(counts.values())
        if mod == "flash_attention":
            row["launches_distributed_lm"] = {
                sub: {r: n[key] for r, n in ranks.items()}
                for sub, ranks in dlm_launches.items()}
            if key == "bfloat16":
                row["max_abs_err"] = max(row["max_abs_err"], dlm_err)
        if mod == "fused_local_phase":
            row["launches_examples"] = dlm_fused[key]
        row["launches_launch"] = {
            sub: ({r: n[key] for r, n in c.items()} if sub == "18c"
                  else c[mod][key] if key else sum(c[mod].values()))
            for sub, c in launch_launches.items()
            if sub != "18c" or mod == "segment_bag"}

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
