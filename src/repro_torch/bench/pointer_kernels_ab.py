#!/usr/bin/env python3
"""A/B of the two pointer kernels, previous design against shipped, on one
CUDA card.

    python3 src/repro_torch/bench/pointer_kernels_ab.py [--reps N]  # checkout root

Builds, beside the shipped `block_pathcompress` and `steepest_neighbor`
libraries, `pointer_kernels_prev.cu` (both kernels as they were before the
streaming redesign) and `pointer_kernels_variants.cu` (the shipped
kernels' own templates with other launch choices), one nvcc each, all at
once.  On phase 7's inputs -- the `grid_512` order field (Perlin seed 42)
at connectivity 6 and 26, and its connectivity-6 steepest pointers at
n = 2^27, 4 rounds, block 4096 -- it

  - holds every design to the plain version (`ref.steepest_neighbor_ref`,
    `ref.block_pathcompress_kernel_ref`): exactly equal;
  - times the designs of each kernel in turns in one process: `--reps`
    calls of each (default 25), the order reversed every other turn, in one
    torch.profiler window (the median device time of each design's kernel)
    and with CUDA events around each call (the median);
  - times the shipped `block_pathcompress` at 1, 2 and 4 rounds (what the
    stream costs without the rounds);
  - times the host side of one launch at a tiny input (n = 4096 pointers,
    an (8, 16, 128) field): the shipped C entries, the same after the
    device queries they keep a process (`csrc/resident.cuh`) made again,
    and the Python wrappers; the median of 400 calls, each timed alone,
    three turns of each.

Sub-ms event times move up to a third between runs (host time inside the
events); compare designs by the device times of one run.  The last line is
a JSON object with every reading.  Needs nvcc and a card of compute
capability 9.0; exits with another code than 0 on any mismatch.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 42
SHAPE = (512, 512, 512)
ROUNDS, BLOCK = 4, 4096
# block_pathcompress's shared configuration: ("ring", stages, ping-pong,
# positions a thread, thread count fixed at compile time) or ("chunks",
# stages, 16-byte chunks a thread); the shipped choice at block 4096 is 2
# stages and a spare buffer (ping-pong), 16 positions a thread, 256 threads
# fixed
BPC_VARIANTS = (("ring", 2, 1, 16, 0), ("ring", 1, 1, 16, 1),
                ("ring", 3, 1, 16, 1), ("ring", 2, 1, 8, 1),
                ("ring", 2, 0, 16, 1), ("ring", 3, 0, 16, 0),
                ("chunks", 3, 4))
# steepest_neighbor's streaming stencil: (rows a tile, planes an x-run or 0
# for the shipped rule, rows loaded a warp a row with 16-byte copies or cell
# by cell); the shipped launch is (16, 0, 1)
STEEPEST_VARIANTS = ((16, 0, 0), (4, 0, 1), (8, 0, 1), (16, 16, 1),
                     (16, 128, 1), (16, 512, 1))


def device_and_event_ms(calls, reps):
    """{label: (median device ms, median event ms)} of calls (label -> fn,
    each launching exactly one kernel), run `reps` times each in turns,
    every other turn in reverse order: once in one torch.profiler window
    (each kernel's own device time) and once with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    order = []
    for r in range(reps):
        order += list(calls) if r % 2 == 0 else list(calls)[::-1]
    # a profiler window can lose most of its device activities (seen once
    # in 21 windows): up to three windows are taken
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)   # a first device activity can go unseen
            for label in order:
                calls[label]()
            torch.cuda.synchronize()
        kernels = sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin" not in e.name),
            key=lambda e: e.time_range.start)
        if len(kernels) == len(order):
            break
        print(f"profiler saw {len(kernels)} device activities for "
              f"{len(order)} calls of one kernel each; window taken again",
              flush=True)
    if len(kernels) != len(order):
        sys.exit(f"profiler saw {len(kernels)} device activities for "
                 f"{len(order)} calls of one kernel each, three times")
    device = {label: [] for label in calls}
    for label, e in zip(order, kernels):
        device[label].append((e.time_range.end - e.time_range.start) / 1e3)
    event = {label: [] for label in calls}
    for label in order:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls[label]()
        end.record()
        end.synchronize()
        event[label].append(start.elapsed_time(end))
    names = {label: e.name for label, e in zip(order, kernels)}
    return {label: {"device_ms": statistics.median(device[label]),
                    "event_ms": statistics.median(event[label]),
                    "kernel": names[label]} for label in calls}


def host_us(calls):
    """{label: median host microseconds of one call} of calls (label -> fn,
    a C entry returning a cudaError_t or a wrapper): 20 warm-up calls each,
    then three turns of 400 calls each timed alone; the median of a turn's
    calls, and of the three turns."""
    import torch
    for label, call in calls.items():       # built, loaded, warm
        for _ in range(20):
            err = call()
            if isinstance(err, int) and err:
                sys.exit(f"{label}: CUDA error {err}")
    torch.cuda.synchronize()
    turns = {label: [] for label in calls}
    for _ in range(3):
        for label, call in calls.items():
            times = []
            for i in range(400):
                t = time.perf_counter()
                call()
                times.append(time.perf_counter() - t)
                if i % 50 == 49:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            turns[label].append(statistics.median(times) * 1e6)
    return {label: statistics.median(v) for label, v in turns.items()}


def launch_host_us(libs, c_fn, smi):
    """Median host microseconds of one call, at inputs too small to keep
    the card busy, of each pointer kernel's C entry (device queries kept),
    the same with the queries made again on each call, and its wrapper."""
    import torch
    from repro_torch.core.steepest import neighbor_offsets
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import block_pathcompress as bpc_mod
    from repro_torch.kernels import steepest_neighbor as steep_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 4096
    ptr = torch.randint(-1, n, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    order = torch.randperm(8 * 16 * 128, generator=gen, device=dev).to(
        torch.int32).reshape(8, 16, 128)
    out_p, out_o = torch.empty_like(ptr), torch.empty_like(order)
    stream = _build.stream(ptr)
    offs = [c for off in neighbor_offsets(3, 6) for c in off]
    offs = (ctypes.c_int * len(offs))(*offs)
    bpc = _build.entry("block_pathcompress", "block_pathcompress_i32",
                       bpc_mod._ARGTYPES)
    steep = _build.entry("steepest_neighbor", "steepest_neighbor",
                         steep_mod._ARGTYPES)
    bpc_re = c_fn("pointer_kernels_variants", "bpc_requery_i32",
                  [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p])
    steep_re = c_fn("pointer_kernels_variants", "steepest_requery",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    calls = {
        "block_pathcompress C entry": lambda: bpc(
            ptr.data_ptr(), out_p.data_ptr(), None, n, 4096, 4, 1, stream),
        "block_pathcompress C entry, queries made again": lambda: bpc_re(
            ptr.data_ptr(), out_p.data_ptr(), n, 4, stream),
        "ops.block_pathcompress": lambda: ops.block_pathcompress(ptr, 4),
        "steepest_neighbor C entry": lambda: steep(
            order.data_ptr(), out_o.data_ptr(), 8, 16, 128, offs, 6, stream),
        "steepest_neighbor C entry, queries made again": lambda: steep_re(
            order.data_ptr(), out_o.data_ptr(), 8, 16, 128, offs, stream),
        "ops.steepest_neighbor": lambda: ops.steepest_neighbor(order, 6)}
    reading = host_us(calls)
    for label, us in reading.items():
        print(f"launch host time, {label}: {us:.2f} us (median of 3 turns "
              f"of 400 calls; {smi})", flush=True)
    return reading


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("pointer_kernels_ab.py: no CUDA device is available")
    sys.path.insert(0, str(HERE.parents[1]))
    from repro_torch.core.ids import compute_order
    from repro_torch.core.steepest import neighbor_offsets
    from repro_torch.data import perlin_noise
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    out_dir = _build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("pointer_kernels_prev", "pointer_kernels_variants"):
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(HERE / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["block_pathcompress", "steepest_neighbor"])
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    for name in ("block_pathcompress", "steepest_neighbor"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def c_fn(lib, symbol, argtypes):
        fn = getattr(libs[lib], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def launched(what, err):
        if err:
            sys.exit(f"{what}: CUDA error {err}")

    def ab_with_variants(calls):
        """The previous design and the shipped one in turns, then each
        other entry of calls in turns with the shipped one."""
        reading = device_and_event_ms(
            {k: calls[k] for k in ("previous", "shipped")}, args.reps)
        for label in calls:
            if label not in reading:
                pair = device_and_event_ms(
                    {"shipped": calls["shipped"], label: calls[label]},
                    args.reps)
                reading[label] = pair[label]
                reading[label]["shipped_device_ms_beside"] = \
                    pair["shipped"]["device_ms"]
        return reading

    dev = torch.device("cuda")
    field = perlin_noise(SHAPE, frequency=0.1, seed=SEED, device=dev)
    order = compute_order(field)
    del field
    x, y, z = SHAPE
    prev_steepest = c_fn("pointer_kernels_prev", "prev_steepest_neighbor",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
                             ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                             ctypes.c_void_p])

    variant_steepest = c_fn(
        "pointer_kernels_variants", "steepest_variant",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p])

    def steepest_with(fn, conn, *launch):
        offs = [c for off in neighbor_offsets(3, conn) for c in off]
        out = torch.empty_like(order)
        launched(f"steepest {launch}", fn(
            order.data_ptr(), out.data_ptr(), x, y, z,
            (ctypes.c_int * len(offs))(*offs), conn, *launch,
            _build.stream(order)))
        return out

    results = {"device": smi, "reps": args.reps}
    for conn in (6, 26):
        calls = {"previous": lambda: steepest_with(prev_steepest, conn),
                 "shipped": lambda: ops.steepest_neighbor(order, conn)}
        for ty, xr, wide in STEEPEST_VARIANTS:
            calls[f"rows{ty}_xrun{xr or 'auto'}{'' if wide else '_cells'}"] = (
                lambda t=ty, r=xr, v=wide: steepest_with(
                    variant_steepest, conn, t, r, v))
        want = ref.steepest_neighbor_ref(order, conn)
        for label, call in calls.items():
            if not torch.equal(call(), want):
                sys.exit(f"steepest_neighbor conn {conn}: {label} differs "
                         "from the plain version")
        del want
        reading = ab_with_variants(calls)
        results[f"steepest_neighbor/conn{conn}"] = reading
        for label, r in reading.items():
            beside = r.get("shipped_device_ms_beside")
            print(f"steepest_neighbor conn {conn} {label}: device "
                  f"{r['device_ms']:.4f} ms, event {r['event_ms']:.4f} ms"
                  + ("" if beside is None else
                     f", shipped beside it {beside:.4f} ms")
                  + f" ({r['kernel'][:60]}; exact; {smi})", flush=True)

    ptr = ref.steepest_neighbor_ref(order, 6).reshape(-1)
    del order
    n = ptr.numel()
    prev_bpc = c_fn("pointer_kernels_prev", "prev_block_pathcompress_i32",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
                        ctypes.c_int, ctypes.c_void_p])
    variant_bpc = {
        "ring": c_fn("pointer_kernels_variants", "bpc_ring_variant_i32",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
        "chunks": c_fn("pointer_kernels_variants", "bpc_chunks_variant_i32",
                       [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])}

    def bpc_prev():
        out = torch.empty_like(ptr)
        launched("prev_block_pathcompress", prev_bpc(
            ptr.data_ptr(), out.data_ptr(), n, BLOCK, ROUNDS,
            _build.stream(ptr)))
        return out

    def bpc_variant(entry, *launch):
        out = torch.empty_like(ptr)
        launched(f"bpc_{entry}_variant {launch}",
                 variant_bpc[entry](ptr.data_ptr(), out.data_ptr(), n, BLOCK,
                                    ROUNDS, *launch, _build.stream(ptr)))
        return out

    want = ref.block_pathcompress_kernel_ref(ptr, ROUNDS, BLOCK)
    calls = {"previous": bpc_prev,
             "shipped": lambda: ops.block_pathcompress(ptr, ROUNDS, BLOCK)}
    for entry, *launch in BPC_VARIANTS:
        label = (f"ring_stages{launch[0]}_"
                 f"{'pingpong' if launch[1] else 'inplace'}_ept{launch[2]}"
                 f"{'' if launch[3] else '_threads_at_runtime'}"
                 if entry == "ring" else
                 f"chunks_stages{launch[0]}_cpt{launch[1]}")
        calls[label] = lambda e=entry, a=tuple(launch): bpc_variant(e, *a)
    for label, call in calls.items():
        if not torch.equal(call(), want):
            sys.exit(f"block_pathcompress: {label} differs from the plain "
                     "version")
    del want
    reading = ab_with_variants(calls)
    results["block_pathcompress"] = reading
    for label, r in reading.items():
        beside = r.get("shipped_device_ms_beside")
        print(f"block_pathcompress n {n} rounds {ROUNDS} block {BLOCK} "
              f"{label}: device {r['device_ms']:.4f} ms, event "
              f"{r['event_ms']:.4f} ms"
              + ("" if beside is None else
                 f", shipped beside it {beside:.4f} ms")
              + f" ({r['kernel'][:60]}; exact; {smi})", flush=True)

    # the shipped kernel at fewer rounds: what the stream costs without them
    by_rounds = {}
    for rounds in (1, 2, ROUNDS):
        by_rounds[f"rounds{rounds}"] = (
            lambda r=rounds: ops.block_pathcompress(ptr, r, BLOCK))
        if not torch.equal(by_rounds[f"rounds{rounds}"](),
                           ref.block_pathcompress_kernel_ref(ptr, rounds,
                                                             BLOCK)):
            sys.exit(f"block_pathcompress rounds {rounds}: shipped differs "
                     "from the plain version")
    reading = device_and_event_ms(by_rounds, args.reps)
    results["block_pathcompress_by_rounds"] = reading
    for label, r in reading.items():
        print(f"block_pathcompress shipped, {label}: device "
              f"{r['device_ms']:.4f} ms, event {r['event_ms']:.4f} ms "
              f"(exact; {smi})", flush=True)

    results["launch_host_us"] = launch_host_us(libs, c_fn, smi)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
