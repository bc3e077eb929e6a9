#!/usr/bin/env python3
"""A/B of design variants of the fp32 attention kernel on one CUDA card.

    python3 src/repro_torch/bench/flash_f32_ab.py            # checkout root
    python3 src/repro_torch/bench/flash_f32_ab.py \
        qk3=-DQK_PRODUCTS=3 g2=-DPV_GROUPS=2 k32g1=-DKEYS=32,-DPV_GROUPS=1

`flash_f32tc` (`kernels/csrc/flash_attention.cu`) sums each score as one
fma chain over d on the CUDA cores and runs O += P V on the tensor cores in
3xTF32, 4 key groups a part, over key tiles of 64.  `flash_f32_variants.cu`
(beside this script) holds the same kernel with switches for each of those
choices (QK_PRODUCTS, PV_GROUPS, KEYS, V_STAGED; see its header).  This
script builds it once for each variant NAME=FLAGS (FLAGS: its -D switches,
comma-separated; by default the set in VARIANTS, and `defaults`, the file
with no switch, which must equal the shipped kernel bit for bit), prints
ptxas's registers and spills of each build, and on SHAPES

  - holds each to the plain version (`ref.flash_attention_kernel_ref`):
    the worst element's share of the 2e-5 limit and where it is;
  - holds each, and the plain version, to float64 on up to 48 rows of head
    0 (the first, middle and last 16);
  - holds the plain version's scores of head 0 (its first key tile, as it
    computes them: one fp32 matmul of cuBLAS) to one fma chain over d a
    score (the shipped kernel's order) bit for bit, and both to float64;
  - times one call of each with CUDA events, in the order shipped, the
    variants, the variants backwards, shipped (median of 5 calls each time).

The last line is a JSON object with every reading.  Needs nvcc and a card of
compute capability 9.0; it checks nothing, it measures.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 16
TOL = 2e-5
VARIANTS = {"defaults": "",
            "qk_3xtf32": "-DQK_PRODUCTS=3",
            "qk_tf32": "-DQK_PRODUCTS=1",
            "chained": "-DPV_GROUPS=0",
            "g1": "-DPV_GROUPS=1",
            "g2": "-DPV_GROUPS=2",
            "g8": "-DPV_GROUPS=8",
            "k32": "-DKEYS=32",
            "k32g1": "-DKEYS=32,-DPV_GROUPS=1",
            "v_staged": "-DV_STAGED=1"}
# (B, H, Hkv, Sq, Sk, D, causal, q and k times): llama3.2-1b widths at 32k
# causal as chip_smoke.py runs them, and with scores of hundreds; 128 query
# rows against 32k keys; D = 128 at 4k causal; the card tests' large-scores
# case (tests/test_torch_cuda.py::test_flash_tc_large_scores), both masks
SHAPES = ((1, 32, 8, 32768, 32768, 64, True, 1),
          (1, 32, 8, 32768, 32768, 64, True, 8),
          (1, 2, 1, 128, 32768, 64, False, 1),
          (1, 8, 2, 4096, 4096, 128, True, 1),
          (1, 4, 2, 200, 300, 64, False, 8),
          (1, 4, 2, 200, 300, 64, True, 8))


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


def share(got, want):
    """(worst |got - want| / (TOL + TOL |want|), its index)."""
    import torch
    s = ((got.double() - want.double()).abs()
         / (TOL + TOL * want.double().abs()))
    at = int(s.argmax())
    return float(s.reshape(-1)[at]), [
        int(i) for i in torch.unravel_index(torch.tensor(at), s.shape)]


def float64_rows(q, k, v, rows, causal, scale):
    """Head 0's output rows `rows` in float64."""
    import torch
    sq, sk = q.shape[2], k.shape[2]
    s = (q[0, 0, rows].double() * scale) @ k[0, 0].double().T
    if causal:
        pos = torch.tensor(rows, device=q.device)[:, None] + (sk - sq)
        s = torch.where(pos >= torch.arange(sk, device=q.device), s, -1e30)
    return s.softmax(-1) @ v[0, 0].double()


def score_order(lib, q, k, scale, stream):
    """The plain version's scores of head 0 against its first key tile,
    computed as it computes them, held to one fma chain over d a score and
    both to float64 (first 256 rows)."""
    import torch
    from repro_torch.kernels import _build
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    rows, keys = min(sq, 256), min(k.shape[2], 128)
    qf = (q.float() * scale).reshape(b, hkv, h // hkv, sq, d)
    plain = (qf @ k[:, :, None, :keys].float().transpose(-1, -2))[
        0, 0, 0, :rows]
    del qf
    qh, kh = q[0, 0, :rows].contiguous(), k[0, 0, :keys].contiguous()
    chain = torch.empty(rows, keys, device=q.device)
    _build.raise_on_error("flash_attention", lib.f32_scores_fma_chain(
        qh.data_ptr(), kh.data_ptr(), chain.data_ptr(), rows, keys, d, scale,
        stream))
    exact = (qh.double() * scale) @ kh.double().T
    return {"scores_equal_to_fma_chain": float((plain == chain).double()
                                               .mean()),
            "scores_max_diff_to_fma_chain": float((plain - chain).abs()
                                                  .max()),
            "plain_scores_max_err": float((plain.double() - exact).abs()
                                          .max()),
            "fma_chain_scores_max_err": float((chain.double() - exact).abs()
                                              .max()),
            "max_abs_score": float(exact.abs().max())}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_f32_ab.py: no CUDA device is available")
    sys.path.insert(0, str(HERE.parents[1]))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as flash_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    variants = dict(arg.split("=", 1) for arg in sys.argv[1:]) or VARIANTS
    out_dir = _build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        lib_path = out_dir / f"libflash_f32_{name}.so"
        procs[name] = lib_path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS,
             *[f for f in flags.split(",") if f], "-o", str(lib_path),
             str(HERE / "flash_f32_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["flash_attention"])
    logs = {"shipped": _build.build_log("flash_attention")}

    def variant(lib):
        fn = lib.flash_attention_f32_variant
        fn.argtypes, fn.restype = flash_mod._ARGTYPES, ctypes.c_int

        def run(q, k, v, causal):
            """The variant, called as the shipped wrapper calls its kernel."""
            b, h, sq, d = q.shape
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d,
                     ref.softmax_scale(d), int(causal), _build.stream(q))
            _build.raise_on_error("flash_attention", err)
            return out
        return run

    designs = {"shipped": flash_mod.flash_attention}
    order_lib = None
    for name, (lib_path, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(lib_path))
        designs[name] = variant(lib)
        order_lib = order_lib or lib
    if order_lib is not None:
        order_lib.f32_scores_fma_chain.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
    ptxas = {}
    for name, log in logs.items():
        # the design's own kernel by its mangled name (the variants' file
        # name is in every kernel name of its build)
        own = "11flash_f32tc" if name == "shipped" else "17flash_f32_variant"
        ptxas[name], dp = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(own + r"ILi(\d+)E", line)
                dp = m and m.group(1)
            elif dp and ("registers" in line or "spill" in line):
                ptxas[name].setdefault(dp, []).append(line.strip())
        print(f"ptxas {name} ({variants.get(name, 'shipped source')}): "
              f"{ptxas[name]}")
    order = list(variants)
    order = ["shipped", *order, *order[::-1], "shipped"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for b, h, hkv, sq, sk, d, causal, mag in SHAPES:
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda") * mag
        k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda") * mag
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
        scale = ref.softmax_scale(d)
        want = ref.flash_attention_kernel_ref(q, k, v, causal=causal)
        rows = sorted({*range(min(16, sq)), *range(sq // 2, sq // 2 + 16),
                       *range(max(sq - 16, 0), sq)} & set(range(sq)))
        exact = float64_rows(q, k, v, rows, causal, scale)
        reading = {"shape": [b, h, hkv, sq, sk, d, causal, mag],
                   "plain_vs_float64": share(want[0, 0, rows], exact)[0]}
        if order_lib is not None:
            reading.update(score_order(order_lib, q, k, scale,
                                       _build.stream(q)))
        for name, run in designs.items():
            got = run(q, k, v, causal)
            torch.cuda.synchronize()
            reading[f"{name}_vs_plain"] = share(got, want)
            reading[f"{name}_vs_float64"] = share(got[0, 0, rows], exact)[0]
            if name != "shipped":
                reading[f"{name}_equals_shipped"] = bool(torch.equal(
                    got, designs["shipped"](q, k, v, causal)))
            del got
        del want
        times = {name: [] for name in designs}
        for name in order:
            times[name].append(event_ms(
                lambda: designs[name](q, k, v, causal)))
        reading.update({f"{name}_ms": t for name, t in times.items()})
        print(f"{reading} ({smi})", flush=True)
        results.append(reading)
        del q, k, v
    print(json.dumps({"device": smi, "variants": variants, "ptxas": ptxas,
                      "results": results}))


if __name__ == "__main__":
    main()
