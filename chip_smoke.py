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
     int64 ids, and the 512^3 grid);
  4. main path at 512^3 (configs `grid_512` / `cc_512`): Perlin field ->
     order field -> an `ms` query and a `cc` query on the top-10% mask
     through `repro_torch.topology.submit`, with the kernel launch counters
     set to 0 just before and read just after;
  5. checks that do not trust the kernel: the plain init-only path on the
     card, scipy.ndimage.label on the host, extrema, segment counts;
  6. numbers: warm query times, kernel and plain times beside the bound,
     peak device memory, rounds and counts, and a torch.profiler breakdown
     of one kernel launch and of one query of each kind.

The last three lines are the `nvidia-smi` line, one JSON object describing
every kernel, and `{"ok": true, "device": {...}}`.  Any failure raises and
the exit code is not 0.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 42                      # Perlin seed of the main path
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores,
                               # taken for the kernel's 32-bit compares
RAGGED = (97, 61, 43)


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


def profile(fn, label, top=6):
    """Device time of one call of fn by operation (torch.profiler): the
    window's wall time, the device's busy time and idle share, and the
    operations that took most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies, memsets): an operator's row
    # repeats the device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if not rows:
        print(f"  profile {label}: wall {wall:.3f} ms, device time not "
              "measured (the profiler saw no device activity)")
        return
    print(f"  profile {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {ms:9.3f} ms  {count:5d}x  {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.configs.dpc_grid import SHAPES, full_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_local_phase as kmod
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.ids import compute_order
    from repro_torch.core.ms_segmentation import ms_segmentation, extrema
    from repro_torch.data import perlin_noise, quantile
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
        kernels.append({
            "name": f"fused_local_phase/{mode}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_local_phase.cu",
            "replaces": "src/repro/kernels/fused_local_phase.py:212",
            "launches": launches[mode], "max_abs_err": err[mode],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "rounds_512": rounds[mode]})
        print(f"  fused_local_phase/{mode}: kernel {kernel_ms:.3f} ms "
              f"({rounds[mode]} rounds), plain {plain_ms:.3f} ms, "
              f"bound {max(by_bytes, by_ops):.3f} ms ({smi})")
    profile(lambda: kmod.fused_local_phase(order, conn), "kernel, manifold")
    profile(ms_query, "ms query")
    profile(cc_query, "cc query")
    for k, v in numbers.items():
        print(f"  {k}: {v}")
    phase("numbers", t0)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
