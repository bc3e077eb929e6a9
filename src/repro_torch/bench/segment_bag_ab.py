#!/usr/bin/env python3
"""A/B of the sum EmbeddingBag kernel, previous design against shipped, on
one CUDA card.

    python3 src/repro_torch/bench/segment_bag_ab.py [--reps N]  # checkout root

Builds, beside the shipped `segment_bag` library, `segment_bag_prev.cu`
(the kernel as it was before its redesign: a warp a bag, one 4- or 2-byte
load a lane a row) and `segment_bag_variants.cu` (the shipped kernel's own
template with other choices), one nvcc each, all at once.  On BST's
multihot table (`configs/bst.py`: 2 x 500,000 rows, D = 32), float32 and
bfloat16, with ids as its callers give them:

  - serve_bulk: (262,144, 16) ids drawn over the whole table, -1 pads and
    64 ids >= V among them (drawn as `chip_smoke.py` phase 7 draws them);
  - BST's per-field calls (`models/bst.py`): field f's ids in
    [f * 500,000, (f + 1) * 500,000), -1 pads drawn as `data/recsys.py`
    draws them (uniform over [-1, 500,000)), both fields in turns as one
    forward pass calls them;
  - two diagnostic patterns: ids confined to the first 131,072 rows (16 MB
    fp32, 8 MB bf16: the table stays in L2, so the kernel runs at the rate
    rows move from L2 to the SMs) and serve_bulk's ids sorted (each row's
    references come together: device memory streams the rows once);

it holds every design to the plain version (`ref.segment_bag_ref`, within
1e-5 fp32 and 3e-2 bf16) and times the designs in turns in one process:
`--reps` calls of each (default 25), the order reversed every other turn,
in one torch.profiler window (the median device time of each call's
kernel) and with CUDA events around each call (the median).  Each variant
(row load width, rows in flight a group, bags a warp, L2 policy off) runs
in turns with the shipped kernel.  Last, the host time of one call at
serve_p99 (512 x 16 ids): the shipped C entry and `ops.embedding_bag`, the
median of 400 calls each timed alone, three turns of each.

Each input's line also gives its bound (ids, distinct rows and output once
over 3.35 TB/s) and, as context and not a bound, the per-reference figure
(every valid reference's row bytes + ids + output over 3.35 TB/s).  The
last line is a JSON object with every reading.  Needs nvcc and a card of
compute capability 9.0; exits with another code than 0 on any mismatch.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from pointer_kernels_ab import device_and_event_ms, host_us

HERE = Path(__file__).resolve().parent
SEED = 18
HBM_BYTES_PER_S = 3.35e12
FIELDS, FIELD_V, D, L = 2, 500_000, 32, 16     # configs/bst.py
SERVE_BULK, SERVE_P99 = 262_144, 512
L2_SLICE = 131_072
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# {dtype: (label, vec, rows, wshift, hint)}; the shipped kernel is vec 16,
# 16 rows a group fp32 and 8 bf16, the rule for bags a warp (-1: four bags
# at L = 16) and the L2 policies on
VARIANTS = {
    "float32": (("rows_by_8B", 8, 16, -1, 1), ("rows_by_4B", 4, 16, -1, 1),
                ("rows_in_flight_4", 16, 4, -1, 1),
                ("rows_in_flight_8", 16, 8, -1, 1),
                ("bags_a_warp_2", 16, 16, 1, 1),
                ("l2_policy_off", 16, 16, -1, 0)),
    "bfloat16": (("rows_by_8B", 8, 8, -1, 1), ("rows_by_4B", 4, 8, -1, 1),
                 ("rows_in_flight_4", 16, 4, -1, 1),
                 ("rows_in_flight_16", 16, 16, -1, 1),
                 ("bags_a_warp_2", 16, 8, 1, 1),
                 ("l2_policy_off", 16, 8, -1, 0))}


def figures(table, ids):
    """(bound ms, per-reference ms, distinct rows, valid references) of one
    call: the bound counts the ids, each distinct row and the output once;
    the per-reference figure every valid reference's row."""
    import torch
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = torch.unique(ids[valid]).numel()
    refs = int(valid.sum())
    row = table.shape[1] * table.element_size()
    stream = ids.numel() * ids.element_size() + ids.shape[0] * row
    return ((stream + rows * row) / HBM_BYTES_PER_S * 1e3,
            (stream + refs * row) / HBM_BYTES_PER_S * 1e3, rows, refs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("segment_bag_ab.py: no CUDA device is available")
    sys.path.insert(0, str(HERE.parents[1]))
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import segment_bag as bag_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    out_dir = _build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("segment_bag_prev", "segment_bag_variants"):
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(HERE / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["segment_bag"])
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))

    def c_fn(lib, symbol, extra=()):
        fn = getattr(libs[lib], symbol)
        fn.argtypes = bag_mod._ARGTYPES[:-1] + list(extra) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    short = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def prev(table, ids):
        fn = c_fn("segment_bag_prev", f"prev_segment_bag_{short[table.dtype]}"
                  f"_i32")
        out = torch.empty((ids.shape[0], D), dtype=table.dtype,
                          device=table.device)
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 table.shape[0], D, ids.shape[0], L, _build.stream(table))
        if err:
            sys.exit(f"previous design: CUDA error {err}")
        return out

    def variant(table, ids, vec, rows, wshift, hint):
        fn = c_fn("segment_bag_variants", f"segment_bag_variant_"
                  f"{short[table.dtype]}_i32", [ctypes.c_int] * 4)
        out = torch.empty((ids.shape[0], D), dtype=table.dtype,
                          device=table.device)
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 table.shape[0], D, ids.shape[0], L, vec, rows, wshift, hint,
                 _build.stream(table))
        if err:
            sys.exit(f"variant {(vec, rows, wshift, hint)}: CUDA error {err}")
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v = FIELDS * FIELD_V
    table32 = torch.randn(v, D, generator=gen, device=dev)
    tables = {"float32": table32, "bfloat16": table32.to(torch.bfloat16)}
    bulk = torch.randint(-1, v, (SERVE_BULK, L), generator=gen, device=dev,
                         dtype=torch.int32)
    over = torch.randint(0, bulk.numel(), (64,), generator=gen, device=dev)
    bulk.view(-1)[over] = v + torch.arange(64, device=dev, dtype=torch.int32)

    def field_ids(b, f):
        x = torch.randint(-1, FIELD_V, (b, L), generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.where(x >= 0, x + f * FIELD_V, -1)

    inputs = {
        "serve_bulk": {"": bulk},
        "bst_per_field_serve_bulk": {f"f{f}": field_ids(SERVE_BULK, f)
                                     for f in range(FIELDS)},
        "l2_slice_131072_rows": {"": torch.randint(
            0, L2_SLICE, (SERVE_BULK, L), generator=gen, device=dev,
            dtype=torch.int32)},
        "serve_bulk_sorted": {"": bulk.view(-1).sort().values.view(
            SERVE_BULK, L).contiguous()},
    }
    results = {"device": smi, "reps": args.reps}
    for dt, table in tables.items():
        for what, by_field in inputs.items():
            designs = {"previous": lambda t, i: prev(t, i),
                       "shipped": lambda t, i: ops.embedding_bag(t, i)}
            if what in ("serve_bulk", "bst_per_field_serve_bulk"):
                for label, *choice in VARIANTS[dt]:
                    designs[label] = (lambda t, i, c=tuple(choice):
                                      variant(t, i, *c))
            for f, ids in by_field.items():
                want = ref.segment_bag_ref(table, ids)
                for label, call in designs.items():
                    got = call(table, ids)
                    torch.cuda.synchronize()
                    if not torch.allclose(got.float(), want.float(),
                                          rtol=TOL[dt], atol=TOL[dt]):
                        sys.exit(f"{what} {f} {dt}: {label} differs from the "
                                 "plain version")
                del want

            def calls(label):
                return {f"{label} {f}".strip():
                        (lambda i=ids: designs[label](table, i))
                        for f, ids in by_field.items()}

            reading = device_and_event_ms(
                {**calls("previous"), **calls("shipped")}, args.reps)
            for label in designs:
                if label in ("previous", "shipped"):
                    continue
                pair = device_and_event_ms(
                    {**calls("shipped"), **calls(label)}, args.reps)
                for key, r in pair.items():
                    if not key.startswith("shipped"):
                        r["shipped_device_ms_beside"] = pair[
                            key.replace(label, "shipped")]["device_ms"]
                        reading[key] = r
            for f, ids in by_field.items():
                bound, per_ref, rows, refs = figures(table, ids)
                print(f"{what} {f} {dt}: bound {bound:.4f} ms (bytes; "
                      f"{rows} distinct rows), per-reference figure "
                      f"{per_ref:.4f} ms ({refs} valid references; context, "
                      "not a bound)", flush=True)
                reading[f"figures {f}".strip()] = {
                    "bound_ms": bound, "per_reference_ms": per_ref,
                    "distinct_rows": rows, "valid_references": refs}
            for key, r in reading.items():
                if "device_ms" not in r:
                    continue
                beside = r.get("shipped_device_ms_beside")
                print(f"{what} {dt} {key}: device {r['device_ms']:.4f} ms, "
                      f"event {r['event_ms']:.4f} ms"
                      + ("" if beside is None else
                         f", shipped beside it {beside:.4f} ms")
                      + f" ({r['kernel'][:50]}; within {TOL[dt]} of plain; "
                      f"{smi})", flush=True)
            results[f"{what}/{dt}"] = reading

    # host time of one call at serve_p99
    table = tables["float32"]
    ids = field_ids(SERVE_P99, 0)
    out = torch.empty((SERVE_P99, D), device=dev)
    entry = _build.entry("segment_bag", "segment_bag_f32_i32",
                         bag_mod._ARGTYPES)
    stream = _build.stream(table)
    host = {"segment_bag C entry": lambda: entry(
                table.data_ptr(), ids.data_ptr(), out.data_ptr(), v, D,
                SERVE_P99, L, stream),
            "ops.embedding_bag": lambda: ops.embedding_bag(table, ids)}
    results["launch_host_us_serve_p99"] = host_us(host)
    for label, us in results["launch_host_us_serve_p99"].items():
        print(f"launch host time at serve_p99 (512 x 16, f32), {label}: "
              f"{us:.2f} us (median of 3 turns of 400 calls; {smi})",
              flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
