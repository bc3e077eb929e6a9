#!/usr/bin/env python3
"""A/B of the fused local-phase kernel's brick stage on one CUDA card.

    python3 src/repro_torch/bench/fused_local_phase_ab.py   # checkout root

`kernels/csrc/fused_local_phase.cu` resolves the chains inside each brick
in shared memory before its global chase.  This script builds, beside it,
`fused_local_phase_l2only.cu`: the same init, chase and round rule with the
brick stage replaced by a pass that writes every voxel's one-hop word, so
the chase walks whole chains through L2.  On the 512^3 main-path inputs
(the `grid_512` order field and the `cc_512` top-10% mask, Perlin seed 42,
connectivity 6, block_x 8) and on two long-chain fields it

  - holds both designs to the plain version (`ref.fused_local_phase_ref`):
    pointers and rounds exactly equal;
  - times one launch of each with CUDA events, in the order shipped,
    variant, variant, shipped (median of 5 calls each time);
  - prints a torch.profiler breakdown of one launch of each: device time
    per kernel (init, brick or word pass, chase) and the idle share.

The last line is a JSON object with every reading.  Needs nvcc and a card of
compute capability 9.0; exits with another code than 0 on any mismatch.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 42
LONG = (("serpentine_order", (8, 512, 512), 1),
        ("z_ramp_order", (64, 512, 512), 8))


def event_ms(fn, reps=5):
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


def device_breakdown(fn, label):
    """{kernel name: device ms} of one call of fn, printed with the window's
    wall time and idle share; empty if the profiler saw no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)   # a first device activity can go unseen
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key}
    busy = sum(rows.values())
    print(f"  profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms"
          + (f", idle share {1 - busy / wall:.3f}" if rows else
             " (no device activity seen)"))
    for key, ms in sorted(rows.items(), key=lambda r: -r[1]):
        print(f"    {ms:9.3f} ms  {key[:90]}")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_local_phase_ab.py: no CUDA device is available")
    sys.path.insert(0, str(HERE.parents[1]))
    from repro_torch.core.ids import compute_order
    from repro_torch.core.steepest import neighbor_offsets
    from repro_torch.data import chains, perlin_noise, quantile
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_local_phase as kmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    out_dir = _build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libfused_local_phase_l2only.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         str(HERE / "fused_local_phase_l2only.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["fused_local_phase"])
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for the variant:\n{log}")
    lib = ctypes.CDLL(str(lib_path))

    def l2only(field, mode, block_x):
        """The variant, called as the shipped wrapper calls its kernel."""
        x, y, z = field.shape
        out = torch.empty(field.shape, dtype=torch.int32, device=field.device)
        scratch = torch.empty(kmod._scratch_bytes(x, y, z, block_x) // 8,
                              dtype=torch.int64, device=field.device)
        offs = [c for off in neighbor_offsets(3, 6) for c in off]
        rounds = ctypes.c_int(0)
        fn = lib.fused_local_phase_l2only_i32
        fn.argtypes, fn.restype = kmod._ARGTYPES, ctypes.c_int
        err = fn(field.data_ptr(), None, out.data_ptr(), scratch.data_ptr(),
                 kmod._MODES[mode], x, y, z, block_x,
                 (ctypes.c_int * len(offs))(*offs), len(offs) // 3,
                 _build.stream(field), ctypes.byref(rounds))
        _build.raise_on_error("fused_local_phase", err)
        return out, rounds.value

    designs = {
        "shipped": lambda f, mode, bx: kmod.fused_local_phase(
            f, 6, mode=mode, block_x=bx),
        "l2only": l2only}
    dev = torch.device("cuda")
    field = perlin_noise((512, 512, 512), frequency=0.1, seed=SEED,
                         device=dev)
    cases = [("grid_512", compute_order(field), "manifold", 8),
             ("cc_512", field > quantile(field, 0.9), "cc", 8)]
    del field
    for make, shape, bx in LONG:
        cases.append((f"{make} {shape}", getattr(chains, make)(
            shape, device=dev), "manifold", bx))

    results = []
    for name, f, mode, bx in cases:
        want, want_rounds = ref.fused_local_phase_ref(f, 6, mode=mode,
                                                      block_x=bx)
        for design, run in designs.items():
            got, rounds = run(f, mode, bx)
            if not (torch.equal(got, want) and rounds == want_rounds):
                sys.exit(f"{name}: {design} differs from the plain version "
                         f"(rounds {rounds} vs {want_rounds})")
        del want
        times = {d: [] for d in designs}
        for design in ("shipped", "l2only", "l2only", "shipped"):
            times[design].append(event_ms(
                lambda: designs[design](f, mode, bx)))
        reading = {"case": name, "mode": mode, "block_x": bx,
                   "rounds": want_rounds}
        for design, run in designs.items():
            reading[f"{design}_ms"] = times[design]
            reading[f"{design}_device_ms"] = device_breakdown(
                lambda: run(f, mode, bx), f"{name}, {design}")
        print(f"{name} ({mode}, block_x {bx}, {want_rounds} rounds): "
              f"shipped {times['shipped']} ms, l2only {times['l2only']} ms, "
              f"both exact ({smi})", flush=True)
        results.append(reading)
    print(json.dumps({"device": smi, "results": results}))


if __name__ == "__main__":
    main()
