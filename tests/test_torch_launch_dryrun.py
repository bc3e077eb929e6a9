"""`repro_torch.launch.{dryrun,roofline,report,perf}` against the JAX
package's launch tools, on the CPU.

One subprocess runs `python -m repro_torch.launch.dryrun --smoke` over
every cell on both production meshes (a fake process group of 256, then
512 ranks; rank 0's step traced on the meta device), JAX's six test cells
(`tests/test_dryrun_cells.py`) among them: exit 0, "0 failures", JAX's
record keys, flops and argument bytes above 0.  The collective bytes of
the llama3.2-1b smoke prefill on (16, 16) are held to a closed form
derived from the layout by hand.  `report.dryrun_table` is JAX's on the
same records (JAX's `report` imports no jax).  JAX's `dryrun`, `roofline`
and `perf` set `XLA_FLAGS` when imported, so they are read in a second
subprocess, run meanwhile: `model_flops` of every LM cell, `fmt_table` of
the port's roofline rows, and the perf variants with their transforms
applied to JAX's configs.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.launch import report as jreport
import repro_torch.configs as pconfigs
from repro_torch.launch import perf as pperf
from repro_torch.launch import report as preport
from repro_torch.launch import roofline as proofline
from repro_torch.launch.cells import all_cells

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
TIMEOUT_S = 300
JAX_CELLS = [("llama3_2_1b", "train_4k"), ("kimi_k2_1t", "decode_32k"),
             ("gat_cora", "ogb_products"), ("bst", "retrieval_cand"),
             ("dpc_grid", "cc_512"), ("dpc_grid", "cc_ragged")]
RECORD_KEYS = {"cell", "mesh", "mesh_shape", "smoke", "memory", "cost",
               "collectives", "lower_s", "compile_s", "note"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}
COLLECTIVE_KEYS = {"all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute", "n_collectives",
                   "total"}

_JAX_SIDE = r"""
import dataclasses, json, sys
import jax.numpy as jnp
from repro import configs
from repro.launch import perf, roofline
rows = json.load(open(sys.argv[1]))
flops = {}
for arch in configs.ARCH_IDS:
    mod = configs.get(arch)
    if mod.FAMILY == "lm":
        for s, shp in mod.SHAPES.items():
            flops[f"{arch}:{s}"] = roofline.model_flops(arch, s, shp, 256)
variants = []
for cell, tag, hyp, tr in perf.VARIANTS:
    cfg = configs.get(cell.split(":")[0]).full_config()
    new = tr(cfg)
    diff = {}
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(new, f.name)
        if a != b:
            if dataclasses.is_dataclass(a):
                b = {g.name: getattr(b, g.name) for g in dataclasses.fields(b)
                     if getattr(a, g.name) != getattr(b, g.name)}
            elif f.name.endswith("dtype"):
                b = jnp.dtype(b).name
            diff[f.name] = b
    variants.append([cell, tag, hyp, diff])
print(json.dumps({"flops": flops, "variants": variants,
                  "table": roofline.fmt_table(rows)}))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the dry run's completed process, its records {(mesh, cell): rec},
    the output root, JAX's side)."""
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--out", str(out)], env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S, cwd=os.path.join(_HERE, ".."))
    recs = {}
    for mesh in ("pod256", "pod2x256"):
        d = out / mesh
        for f in sorted(os.listdir(d)) if d.is_dir() else []:
            r = json.loads((d / f).read_text())
            recs[(mesh, r["cell"])] = r
    rows = [proofline.analyze_cell(a, s, recs[("pod256", f"{a}:{s}")])
            for a, s in all_cells() if ("pod256", f"{a}:{s}") in recs]
    (out / "rows.json").write_text(json.dumps(rows))
    jside = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(out / "rows.json")],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert jside.returncode == 0, jside.stderr[-3000:]
    return proc, recs, out, rows, json.loads(jside.stdout.splitlines()[-1])


def test_smoke_dry_run_covers_every_cell_on_both_meshes(run):
    proc, recs, _, _, _ = run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "0 failures" in proc.stdout
    for mesh in ("pod256", "pod2x256"):
        assert {c for m, c in recs if m == mesh} == {
            f"{a}:{s}" for a, s in all_cells()}


@pytest.mark.parametrize("mesh", ["pod256", "pod2x256"])
@pytest.mark.parametrize("arch,shape", JAX_CELLS)
def test_jax_test_cells_records(run, arch, shape, mesh):
    rec = run[1][(mesh, f"{arch}:{shape}")]
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert rec["mesh_shape"] == ({"data": 16, "model": 16} if mesh ==
                                 "pod256" else {"pod": 2, "data": 16,
                                                "model": 16})
    assert rec["rank"] == 0 and rec["smoke"] is True
    c = rec["collectives"]
    assert c["total"] == sum(v for k, v in c.items()
                             if k not in ("n_collectives", "total"))
    if arch.startswith("dpc"):
        assert "one round" in rec["note"]


def test_lm_prefill_collectives_are_the_closed_form(run):
    """llama3.2-1b smoke prefill (32 x 256) on (16, 16), SP on: per rank
    B = 2 rows; the embedding's FSDP gather and SP reduce-scatter; a layer
    gathers the stream twice (SP), wq / wo / the three FFN weights over
    "data", wk and wv over "data" and then over "model" (4 KV heads for
    16 ranks: each takes its head's columns), reduce-scatters twice, and
    gathers its K and V heads for the cache; then the last position, the
    unembedding and the logits."""
    rec = run[1][("pod256", "llama3_2_1b:prefill_32k")]
    cfg = pconfigs.get("llama3.2-1b").smoke_config()
    f, tp = 4, 16
    b, s = 32 // 16, 256
    d, v, dh, ff = cfg.d_model, cfg.vocab, cfg.head_dim, cfg.d_ff
    h, hkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layer = (2 * b * s * d + d * h * dh // tp + 2 * (
        d * hkv * dh // tp + d * hkv * dh) + h * dh * d // tp
        + 3 * d * ff // tp + 2 * b * tp * s * dh) * f
    gathers = (v // tp * d + b * tp * d + d * v // tp + b * v) * f
    c = rec["collectives"]
    assert c["all-gather"] == gathers + L * layer
    assert c["reduce-scatter"] == b * s // tp * d * f * (1 + 2 * L)
    assert c["all-reduce"] == c["all-to-all"] == 0
    assert c["collective-permute"] == 0
    assert c["n_collectives"] == (3 + 13 * L + 1) + (1 + 2 * L)


def test_dryrun_table_is_jax(run):
    out = run[2]
    got = preport.dryrun_table(str(out))
    assert got == jreport.dryrun_table(str(out))
    assert len(got.splitlines()) == 2 + 2 * len(all_cells())


def test_model_flops_and_fmt_table_are_jax(run):
    _, _, _, rows, jside = run
    n = 0
    for arch, shape in all_cells():
        mod = pconfigs.get(arch)
        if mod.FAMILY != "lm":
            assert proofline.model_flops(arch, shape, mod.SHAPES[shape],
                                         256) is None
            continue
        n += 1
        assert proofline.model_flops(arch, shape, mod.SHAPES[shape],
                                     256) == jside["flops"][f"{arch}:{shape}"]
    assert n == 20
    assert proofline.fmt_table(rows) == jside["table"]
    assert all(r["scan_corrected"] is False for r in rows)


def test_roofline_cli_writes_its_table(run, tmp_path):
    out = run[2]
    dest = tmp_path / "roof" / "roofline.json"
    proofline.main(["--dryrun-dir", str(out / "pod256"), "--out",
                    str(dest), "--arch", "llama3_2_1b"])
    rows = json.loads(dest.read_text())
    assert [r["cell"] for r in rows] == [
        f"llama3_2_1b:{s}" for s in pconfigs.get("llama3_2_1b").SHAPES]
    assert dest.with_suffix(".md").read_text() == proofline.fmt_table(
        rows) + "\n"


def _cfg_diff(cfg, new):
    """The fields of `new` that differ from `cfg`, as JAX's side writes
    them (a nested config: its changed fields; a dtype: its name)."""
    diff = {}
    for fld in dataclasses.fields(cfg):
        a, b = getattr(cfg, fld.name), getattr(new, fld.name)
        if a != b:
            if dataclasses.is_dataclass(a):
                b = {g.name: getattr(b, g.name)
                     for g in dataclasses.fields(b)
                     if getattr(a, g.name) != getattr(b, g.name)}
            elif fld.name.endswith("dtype"):
                b = str(b).removeprefix("torch.")
            diff[fld.name] = b
    return diff


def test_perf_variants_are_jax(run):
    """The port's variants are JAX's (cell, tag, transform) in JAX's order;
    each JAX variant left out differs from the baseline or from a kept
    variant of its cell only in `moe.dispatch`, one partition in the
    port."""
    jvariants = {(c, t): d for c, t, _, d in run[4]["variants"]}
    order = [k for k in jvariants]
    kept = [(c, t) for c, t, _, _ in pperf.VARIANTS]
    assert kept == [k for k in order if k in kept]
    for cell, tag, hyp, tr in pperf.VARIANTS:
        cfg = pconfigs.get(cell.split(":")[0]).full_config()
        assert hyp and _cfg_diff(cfg, tr(cfg)) == jvariants[(cell, tag)], (
            cell, tag)

    def no_dispatch(diff):
        moe = {k: v for k, v in diff.get("moe", {}).items()
               if k != "dispatch"}
        return {k: v for k, v in diff.items() if k != "moe"} | (
            {"moe": moe} if moe else {})

    dropped = [k for k in order if k not in kept]
    assert len(dropped) == 4
    for cell, tag in dropped:
        same = [{}] + [jvariants[k] for k in kept if k[0] == cell]
        assert no_dispatch(jvariants[(cell, tag)]) in [
            no_dispatch(d) for d in same], (cell, tag)
