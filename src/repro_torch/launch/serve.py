"""Batched-serving launcher (port of `repro/launch/serve.py`), with JAX's
flags plus `--device` (``cuda`` unless given).

  # LM prefill + KV-cache greedy decode (the dense LMs of repro_torch.configs)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --batch 4 --prompt-len 32 --gen 16

  # batched multi-tenant topology queries (repro_torch.serve, DESIGN.md §Serve)
  PYTHONPATH=src python -m repro_torch.launch.serve --topology --smoke \\
      --requests 24 --repeat 2

  # the async deadline-aware plane, open-loop arrivals (DESIGN.md §Serve-v2)
  PYTHONPATH=src python -m repro_torch.launch.serve --topology --async \\
      --smoke --requests 24

  # overload: 4x-oversubscribed arrivals against tight admission budgets
  # (DESIGN.md §Serve-v3)
  PYTHONPATH=src python -m repro_torch.launch.serve --topology --async \\
      --smoke --requests 16 --overload

Add `--device cpu` to run on the CPU.  The LM mode takes the LM archs,
dense and MoE; any other arch id (a GNN, BST) loads its config and is
refused with a ValueError naming its family.  It draws its weights and
prompts from a `torch.Generator` seeded with `--seed`, runs one untimed
generation (kernel build, warm-up), then `LM_RUNS` timed ones, each a
prefill and `--gen - 1` greedy decode steps, timed with CUDA events on a
card (the host clock on the CPU); it prints JAX's two lines and a JSON
stats line, and returns the median decode tokens/s.  Under `torchrun`
with more than one rank the LM mode binds `launch.mesh.make_smoke_mesh()`
as JAX's does: the weights are cut to each rank's FSDP x TP blocks, the
prompts to its "dp" block, and the KV cache to its block of the sequence
(`lm.CACHE_LOGICAL`); rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.launch.mesh import join_torchrun, make_smoke_mesh
from repro_torch.models import lm
from repro_torch.runtime.meshctx import LOGICAL_AXES, use_mesh

LM_RUNS = 3        # timed generations of the LM mode


def _timed(fn, dev):
    """(fn(), its milliseconds): CUDA events around it on a card, the host
    clock after a synchronize elsewhere."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def generate(params, prompts, cfg, gen: int, max_len: int | None = None):
    """Greedy generation: prefill the prompts (B, P), then `gen - 1` decode
    steps.  Returns (tokens (B, gen), last logits, prefill ms, decode ms
    of the `gen - 1` steps together)."""
    dev = prompts.device
    max_len = max_len or prompts.shape[1] + gen
    (logits, cache), prefill_ms = _timed(
        lambda: lm.prefill(params, prompts, cfg, max_len=max_len), dev)
    out = [logits.argmax(-1)[:, None]]

    def decode():
        nonlocal logits, cache
        for _ in range(gen - 1):
            logits, cache = lm.decode_step(params, cache, out[-1], cfg)
            out.append(logits.argmax(-1)[:, None])

    _, decode_ms = _timed(decode, dev)
    return torch.cat(out, dim=1), logits, prefill_ms, decode_ms


def serve_lm(args):
    mod = configs.get(args.arch)
    if mod.FAMILY != "lm":
        raise ValueError(f"serve.py's LM mode drives LM archs, not "
                         f"{args.arch!r} (family {mod.FAMILY!r})")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    dev = join_torchrun(resolve_device(args.device))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_smoke_mesh(device=dev)
        cfg = lm.bind_mesh(cfg, mesh)
        params = lm.shard_params(params, cfg, mesh)
        prompts = mesh.block(prompts, LOGICAL_AXES["dp"], 0)

    with use_mesh(mesh):
        generate(params, prompts, cfg, min(args.gen, 2))     # warm-up
        runs = [generate(params, prompts, cfg, args.gen)
                for _ in range(LM_RUNS)]
    if mesh is not None and mesh.rank:
        return None
    toks, logits = runs[-1][0], runs[-1][1]
    prefill_ms = [r[2] for r in runs]
    step_ms = [r[3] / max(args.gen - 1, 1) for r in runs]
    tps = args.batch / max(statistics.median(step_ms), 1e-9) * 1e3
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{statistics.median(prefill_ms):.1f}ms; decode {args.gen - 1} "
          f"steps at {tps:.1f} tok/s (warm, median of {LM_RUNS})")
    print("[serve] sample continuation ids:", toks[0][:12].cpu().numpy())
    print("[serve] lm stats:", json.dumps({
        "arch": cfg.name, "device": str(dev), "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "prefills": LM_RUNS + 1, "prefill_ms": prefill_ms,
        "decode_ms_per_step": step_ms, "tokens_per_s": tps,
        "continuation": toks.tolist()}))
    assert bool(torch.isfinite(logits).all())
    return tps


def serve_topology(args):
    """Drive the batched topology engine over a synthetic mixed workload.

    `--repeat` replays the same request sequence (same layouts, so the same
    bucket occupancies); the second pass is served entirely from the
    executable cache.
    """
    from repro_torch.serve import TopologyEngine
    from repro_torch.serve.workload import synthetic_requests

    mod = configs.get("serve_topology")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    dev = resolve_device(args.device)
    eng = TopologyEngine(min_extent=cfg.min_extent, max_batch=cfg.max_batch,
                         cache_capacity=cfg.cache_capacity,
                         slot_cost_cells=cfg.slot_cost_cells or None,
                         device=dev)

    t_total = 0.0
    n_total = 0
    for rep in range(args.repeat):
        reqs = synthetic_requests(
            args.requests, cfg.shapes, mix=cfg.mix,
            connectivity=cfg.connectivity, sweep_k=cfg.sweep_k,
            seed=args.seed, device=dev)
        results, ms = _timed(lambda: eng.submit_batch(reqs), dev)
        dt = ms / 1e3
        t_total += dt
        n_total += len(results)
        info = eng.stats.as_dict()
        print(f"[serve-topology] pass {rep}: {len(results)} requests in "
              f"{dt * 1e3:.1f}ms ({len(results) / max(dt, 1e-9):.1f} req/s); "
              f"cumulative hit_rate={info['hit_rate']:.2f} "
              f"pad_fraction={info['pad_fraction']:.2f}")
    print("[serve-topology] engine stats:",
          json.dumps(eng.stats.as_dict(), sort_keys=True))
    return n_total / max(t_total, 1e-9)


def serve_topology_async(args):
    """Drive the async deadline-aware plane over a replayable open-loop
    trace (DESIGN.md §Serve-v2), on a `VirtualClock` charged with the
    measured execution time."""
    from repro_torch.serve import AsyncTopologyEngine, VirtualClock
    from repro_torch.serve.workload import synthetic_trace

    mod = configs.get("serve_topology")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    dev = resolve_device(args.device)
    trace = synthetic_trace(
        args.requests, cfg.shapes, mix=cfg.mix,
        connectivity=cfg.connectivity, sweep_k=cfg.sweep_k, seed=args.seed,
        rate=args.rate if args.rate is not None else cfg.rate,
        deadline_slack=(args.deadline_slack if args.deadline_slack is not None
                        else cfg.deadline_slack))
    eng = AsyncTopologyEngine(
        min_extent=cfg.min_extent, max_batch=cfg.max_batch,
        cache_capacity=cfg.cache_capacity,
        slot_cost_cells=cfg.slot_cost_cells or None,
        clock=VirtualClock(), charge_execution_time=True,
        max_queue_depth=cfg.max_queue_depth,
        max_inflight_cells=cfg.max_inflight_cells,
        shed_policy=cfg.shed_policy, device=dev)

    t0 = time.perf_counter()
    handles = []
    for req, (t, dl) in zip(trace.requests(device=dev), trace.arrivals):
        if t > eng.clock.now():
            eng.advance(t - eng.clock.now())
        handles.append(eng.submit(req, deadline=dl))
    # run time out to the deadline horizon first (deadline flushes get
    # their chance), then drain what never came under pressure
    horizon = max((dl for _, dl in trace.arrivals if dl is not None),
                  default=eng.clock.now())
    if horizon > eng.clock.now():
        eng.advance(horizon - eng.clock.now())
    eng.drain()
    wall = time.perf_counter() - t0
    assert all(h.done() for h in handles)

    s = eng.stats
    assert (s.flush_capacity + s.flush_deadline + s.flush_drain
            + s.flush_retry == s.batches)
    lat = np.asarray(eng.latencies)
    p50, p99 = (float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
                ) if lat.size else (0.0, 0.0)
    print(f"[serve-async] {len(handles)} requests in {wall * 1e3:.0f}ms wall "
          f"({len(handles) / max(wall, 1e-9):.1f} req/s incl. builds); "
          f"flushes capacity={s.flush_capacity} deadline={s.flush_deadline} "
          f"drain={s.flush_drain} retry={s.flush_retry}; "
          f"deadline_hit_rate={s.deadline_hit_rate:.2f}; "
          f"latency p50={p50 * 1e3:.1f}ms p99={p99 * 1e3:.1f}ms (virtual); "
          f"evictions={s.cache_evictions} queue_peak={s.queue_depth_peak}; "
          f"rejected={s.rejected} shed={s.shed}")
    print("[serve-async] engine stats:",
          json.dumps(eng.stats.as_dict(), sort_keys=True))
    print("[serve-async] replay trace:",
          json.dumps(trace.as_dict(), sort_keys=True))
    return len(handles) / max(wall, 1e-9)


def serve_topology_overload(args):
    """Overload (DESIGN.md §Serve-v3): measure the sustainable closed-loop
    rate, replay an open-loop trace at `cfg.overload_factor` times it
    against tight admission budgets with `shed_policy="hopeless"`, and
    assert the overload contract: the remainder is rejected or shed with
    typed errors only, and every completed request equals the sequential
    `submit_many` facade bit for bit."""
    from repro_torch.serve import (AsyncTopologyEngine, PlaneError,
                                   SharedExecutableCache, TopologyEngine,
                                   VirtualClock)
    from repro_torch.serve.workload import overload_trace, synthetic_requests
    from repro_torch.topology import submit_many

    mod = configs.get("serve_topology")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    dev = resolve_device(args.device)

    # sustainable rate: a warm closed-loop pass on a sync engine sharing the
    # overload engine's cache, so the overload run starts warm
    cache = SharedExecutableCache(capacity=cfg.cache_capacity)
    reqs = synthetic_requests(
        args.requests, cfg.shapes, mix=cfg.mix,
        connectivity=cfg.connectivity, sweep_k=cfg.sweep_k, seed=args.seed,
        device=dev)
    sync = TopologyEngine(min_extent=cfg.min_extent, max_batch=cfg.max_batch,
                          slot_cost_cells=cfg.slot_cost_cells or None,
                          compile_cache=cache, name="measure", device=dev)
    sync.submit_batch(reqs)                       # cold (builds)
    _, ms = _timed(lambda: sync.submit_batch(reqs), dev)    # warm
    sustainable = len(reqs) / max(ms / 1e3, 1e-9)

    trace = overload_trace(
        args.requests, cfg.shapes, mix=cfg.mix,
        connectivity=cfg.connectivity, sweep_k=cfg.sweep_k, seed=args.seed,
        sustainable_rps=sustainable, factor=cfg.overload_factor)
    eng = AsyncTopologyEngine(
        min_extent=cfg.min_extent, max_batch=cfg.max_batch,
        cache_capacity=cfg.cache_capacity,
        slot_cost_cells=cfg.slot_cost_cells or None,
        clock=VirtualClock(), charge_execution_time=True,
        max_queue_depth=cfg.overload_queue_depth,
        max_inflight_cells=cfg.max_inflight_cells,
        shed_policy="hopeless", default_estimate=1.0 / sustainable,
        compile_cache=cache, name="overload", device=dev)

    handles = []
    for req, (t, dl) in zip(trace.requests(device=dev), trace.arrivals):
        if t > eng.clock.now():
            eng.advance(t - eng.clock.now())
        handles.append(eng.submit(req, deadline=dl))
    eng.drain()

    s = eng.stats
    assert all(h.done() for h in handles)
    for h in handles:
        exc = h.exception()
        assert exc is None or isinstance(exc, PlaneError), \
            f"non-typed error escaped the plane: {exc!r}"
    assert s.rejected + s.shed > 0, \
        f"{cfg.overload_factor}x overload produced no rejections/sheds"
    assert s.completed + s.failures + s.shed == s.requests
    assert (s.flush_capacity + s.flush_deadline + s.flush_drain
            + s.flush_retry == s.batches)
    completed = [h for h in handles if h.exception() is None]
    if completed:
        want = submit_many([h.request for h in completed], device=dev)
        for h, w in zip(completed, want):
            for f in ("labels", "ascending", "descending", "segmentation"):
                a, b = getattr(h.result(), f), getattr(w, f)
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
    n = len(handles)
    print(f"[serve-overload] {n} requests at "
          f"{cfg.overload_factor:.0f}x sustainable "
          f"({sustainable:.1f} req/s): completed={s.completed} "
          f"rejected={s.rejected} (depth-limited={s.queue_depth_limit}) "
          f"shed={s.shed} failures={s.failures}; "
          f"parity held on all {len(completed)} completed; "
          f"shared cache builds={cache.compiles} "
          f"(async engine reused {eng.stats.cache_hits})")
    print("[serve-overload] engine stats:",
          json.dumps(eng.stats.as_dict(), sort_keys=True))
    print("[serve-overload] replay trace:",
          json.dumps(trace.as_dict(), sort_keys=True))
    return s.rejected + s.shed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--topology", action="store_true",
                    help="serve batched CC/MS topology queries instead of LM")
    ap.add_argument("--requests", type=int, default=24,
                    help="topology mode: requests per pass")
    ap.add_argument("--repeat", type=int, default=2,
                    help="topology mode: workload passes (2nd hits the "
                         "executable cache)")
    ap.add_argument("--async", dest="async_plane", action="store_true",
                    help="topology mode: async deadline-aware plane with "
                         "open-loop arrivals (DESIGN.md §Serve-v2)")
    ap.add_argument("--rate", type=float, default=None,
                    help="async mode: Poisson arrival rate (req/s); "
                         "defaults to the config's")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="async mode: mean deadline slack (s); defaults "
                         "to the config's")
    ap.add_argument("--overload", action="store_true",
                    help="async mode: 4x-oversubscribed overload smoke "
                         "asserting typed rejections/sheds + parity "
                         "(DESIGN.md §Serve-v3)")
    args = ap.parse_args(argv)
    if args.topology and args.async_plane and args.overload:
        return serve_topology_overload(args)
    if args.topology and args.async_plane:
        return serve_topology_async(args)
    if args.topology:
        return serve_topology(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
