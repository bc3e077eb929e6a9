"""Rank side of `tests/test_torch_distributed_lm.py`: one gloo group of 8
CPU ranks runs the port's LM on `runtime.meshctx` meshes and writes what
it found to `<out>/rank<r>.pt`.

    python tests/torch_lm_ranks.py RANK WORLD STORE_FILE OUT_DIR

Imports torch and the port only (no jax).  The inputs (JAX's weights
carried over by `interop`, its tokens, its prefill cache, an MoE layer
and its tokens) are in `<out>/inputs.pt`, written by the test.  Each rank
records, under the names of `CASES`:

  step/<fsdp>/<seq_shard>  one sharded AdamW step on mesh (2, 4) from
                           JAX's weights: the loss and the updated
                           parameters gathered whole, and each leaf's
                           (local numel, whole numel, blocks);
  decode                   context-parallel decode of JAX's prefill cache
                           sequence-sharded over ("data", "model"): the
                           logits and the new cache length;
  moe                      the shard_map MoE on (2, 4): y gathered over the
                           data shards, aux;
  ckpt                     the (params, AdamW state) of step/1/1 saved on
                           (2, 4) and loaded into a template sharded on
                           (4, 2), gathered whole;
  launch/<arch>            `launch.train.main` on the 8 ranks from JAX's
                           weights (deepseek through a chaos restart):
                           eval loss and report;
  meshes                   `launch.mesh`'s layouts and errors on 8 ranks;
  kv                       one sharded AdamW step of the llama3.2-1b smoke
                           config on mesh (1, 8): 8 "model" ranks over 4
                           KV heads; the loss, the gradients and the
                           updated parameters gathered whole, and this
                           rank's unsharded step;
  bst                      BST's smoke config on (2, 4) from JAX's weights:
                           logits gathered over the data shards, the loss
                           and its gradients gathered whole, retrieval of
                           800 candidates split over "data"; and the same
                           unsharded on this rank;
  gnn/<arch>               each GNN smoke config on (2, 4), the batch's
                           arrays split into 8 blocks (`gnn.shard_batch`):
                           the output (node outputs gathered), the loss,
                           the gradients (whole on every rank); and the
                           same unsharded on this rank.
"""
import dataclasses
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

WORLD = 8
MESH = (2, 4)
RESHARD = (4, 2)
COMBOS = ((True, True), (True, False), (False, True), (False, False))
# `main`'s mesh, and --chaos (one failure at 60% of the steps, a restore of the
# step-5 checkpoint onto the mesh, the same final state)
LAUNCH = {"llama3.2-1b": ((4, 2), False), "deepseek-moe-16b": (None, True)}
LAUNCH_ARGS = dict(steps=12, batch=4, seq=16, lr=3e-3, ckpt_every=5)
LR = 1e-3
GNN_ARCHS = ("gat_cora", "schnet", "meshgraphnet", "dimenet")


def lm_test_config():
    """JAX's own test configuration (`tests/test_distributed_lm.py`)."""
    from repro_torch.models.lm import LMConfig
    return LMConfig(name="t", n_layers=2, d_model=64, n_heads=8,
                    n_kv_heads=4, d_ff=128, vocab=128, d_head=8,
                    loss_chunks=2)


def moe_config():
    import repro_torch.configs as configs
    cfg = configs.get("deepseek-moe-16b").smoke_config()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="shard_map"))


def _step(params, batch, cfg, mesh):
    """One AdamW step of `launch.train.make_step`'s shape on `mesh`."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.meshctx import LOGICAL_AXES, use_mesh
    from repro_torch.tree import tree_map
    opt = adamw(LR, norm_fn=lm.global_norm_fn(cfg, mesh))
    local = lm.shard_params(params, cfg, mesh)
    state = opt.init(local)
    dp = LOGICAL_AXES["dp"]
    b = {k: mesh.block(v, dp, 0) for k, v in batch.items()}
    with use_mesh(mesh):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), local)
        loss, _ = lm.loss_fn(leaves, b, cfg)
        loss.backward()
        grads = tree_map(lambda t: t.grad, leaves)
        new, state, _ = opt.update(grads, state, local)
    return float(loss), local, new, state, grads


def kv_config():
    """llama3.2-1b's smoke config: 4 KV heads, fewer than 8 "model"
    ranks."""
    import repro_torch.configs as configs
    return configs.get("llama3.2-1b").smoke_config()


def _step_unsharded(params, batch, cfg):
    """The same AdamW step on this rank, no mesh: (loss, new params,
    gradients)."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    opt = adamw(LR)
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = lm.loss_fn(leaves, batch, cfg)
    loss.backward()
    grads = tree_map(lambda t: t.grad, leaves)
    new, _, _ = opt.update(grads, opt.init(params), params)
    return float(loss), new, grads


def _loss_grads(loss_fn, params, batch, mesh):
    """(loss, aux, gradients) of `loss_fn` on the leaves of `params`, under
    `mesh` when one is given."""
    import contextlib
    from repro_torch.runtime.meshctx import use_mesh
    from repro_torch.tree import tree_map
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        loss, aux = loss_fn(leaves, batch)
    loss.backward()
    return float(loss), {k: float(v) for k, v in aux.items()}, tree_map(
        lambda t: t.grad, leaves)


def _bst(inp, mesh):
    """Sharded BST on `mesh` and the same unsharded on this rank."""
    from repro_torch import configs
    from repro_torch.models import bst
    from repro_torch.runtime.meshctx import use_mesh
    cfg = configs.get("bst").smoke_config()
    params, batch, retr = inp["bst_params"], inp["bst_batch"], inp[
        "bst_retrieval"]
    local = bst.shard_params(params, cfg, mesh)
    lb = {k: mesh.block(v, ("data",), 0) for k, v in batch.items()}
    lr = dict(retr, candidates=mesh.block(retr["candidates"], ("data",), 1))
    with use_mesh(mesh):
        logits = mesh.gather(bst.forward(local, lb, cfg), ("data",), 0)
        vals, ids = bst.retrieval_step(local, lr, cfg, top_k=100)
    loss, aux, grads = _loss_grads(lambda p, b: bst.loss_fn(p, b, cfg),
                                   local, lb, mesh)
    one = _loss_grads(lambda p, b: bst.loss_fn(p, b, cfg), params, batch,
                      None)
    return {"logits": logits, "loss": loss, "acc": aux["acc"],
            "grads": bst.unshard_params(grads, cfg, mesh),
            "retrieval": (vals, ids),
            "one": {"logits": bst.forward(params, batch, cfg),
                    "loss": one[0], "grads": one[2],
                    "retrieval": bst.retrieval_step(params, retr, cfg,
                                                    top_k=100)}}


def _gnn(arch, inp, mesh):
    """Sharded GNN on `mesh` (every array split over the 8 ranks) and the
    same unsharded on this rank."""
    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.runtime.meshctx import use_mesh
    cfg = configs.get(arch).smoke_config()
    params, batch = inp[f"gnn_params/{arch}"], inp[f"gnn_batch/{arch}"]
    local = gnn.shard_batch(batch, mesh)
    with use_mesh(mesh):
        out = gnn.apply(params, local, cfg)
    if out.shape[0] != gnn.apply(params, batch, cfg).shape[0]:
        out = mesh.gather(out, mesh.axis_names, 0)     # node outputs
    loss, aux, grads = _loss_grads(lambda p, b: gnn.loss_fn(p, b, cfg),
                                   params, local, mesh)
    one = _loss_grads(lambda p, b: gnn.loss_fn(p, b, cfg), params, batch,
                      None)
    return {"out": out, "loss": loss, "aux": aux, "grads": grads,
            "one": {"out": gnn.apply(params, batch, cfg), "loss": one[0],
                    "aux": one[1], "grads": one[2]}}


def main(rank, world, store, out_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ptrain
    from repro_torch.models import lm
    from repro_torch.runtime.meshctx import Mesh, use_mesh
    from repro_torch.tree import tree_map_with_names

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    out = {"errors": {}, "seconds": {}}

    def case(name, fn):
        t = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:
            out["errors"][name] = traceback.format_exc()
        out["seconds"][name] = time.perf_counter() - t

    cpu = torch.device("cpu")
    mesh = Mesh(MESH, ("data", "model"), cpu)
    other = Mesh(RESHARD, ("data", "model"), cpu)

    def meshes():
        flat = lmesh.make_flat_mesh(mesh)
        block = lmesh.make_block_mesh((2, 2, 2), mesh)
        smoke = lmesh.make_smoke_mesh(device=cpu)
        got = {"flat": (flat.layout, flat.names, flat.coords),
               "block": (block.layout, block.names, block.coords),
               "smoke": (tuple(smoke.shape.items()), smoke.index("model")),
               "mesh": (mesh.coords, mesh.index("data"),
                        mesh.index(("data", "model")))}
        for what, fn in (("block_bad", lambda: lmesh.make_block_mesh(
                (2, 2), mesh)),
                ("production", lambda: lmesh.make_production_mesh(
                    device=cpu))):
            try:
                fn()
                got[what] = "no error"
            except ValueError as e:
                got[what] = str(e)
        return got

    case("meshes", meshes)

    cfg0 = lm_test_config()
    params = inp["dense_params"]
    batch = {"tokens": inp["tokens"], "labels": inp["tokens"]}
    for fsdp, sp in COMBOS:
        cfg = dataclasses.replace(cfg0, fsdp=fsdp, seq_shard=sp)

        def step(cfg=cfg):
            loss, local, new, state, _ = _step(params, batch, cfg, mesh)
            whole = lm.unshard_params(new, cfg, mesh)
            full = {}
            tree_map_with_names(lambda n, t: full.__setitem__(n, t),
                                params)
            numel = {}
            tree_map_with_names(lambda n, t: numel.__setitem__(
                n, (t.numel(), full[n].numel())), local)
            if (fsdp, sp) == (True, True):
                out["_state"] = (new, state)
            return {"loss": loss, "params": whole, "numel": numel}

        case(f"step/{int(fsdp)}/{int(sp)}", step)

    def decode():
        local = lm.shard_params(params, cfg0, mesh)
        cache = {"k": inp["cache_k"], "v": inp["cache_v"],
                 "length": int(inp["cache_length"])}
        cache = lm.shard_kv_cache(cache, mesh, lm.LONG_CACHE_LOGICAL)
        with use_mesh(mesh):
            logits, new = lm.decode_step(local, cache, inp["next"], cfg0)
        return {"logits": logits, "length": new["length"],
                "block": tuple(new["k"].shape)}

    case("decode", decode)

    def moe():
        mcfg = moe_config()
        lp = {k: v for k, v in inp["moe_layer"].items()}
        spec = lm.param_logical_specs(mcfg)["layers"][0]
        from repro_torch.runtime.meshctx import local_block, logical_to_spec
        lp = {k: local_block(v, logical_to_spec(spec[k], mesh), mesh)
              for k, v in lp.items()}
        x = mesh.block(inp["moe_x"], ("data",), 0)
        with use_mesh(mesh):
            y, aux = lm._moe_ffn(x, lp, mcfg)
        return {"y": mesh.gather(y, ("data",), 0), "aux": float(aux)}

    case("moe", moe)

    def ckpt():
        cfg = dataclasses.replace(cfg0)
        new, state = out.pop("_state")
        specs = ptrain.state_specs(cfg)
        d = os.path.join(out_dir, "ckpt_reshard")
        with use_mesh(mesh):
            CheckpointManager(d, async_write=False, specs=specs).save(
                1, (new, state))
        template = (lm.shard_params(params, cfg, other),
                    {"m": lm.shard_params(params, cfg, other),
                     "v": lm.shard_params(params, cfg, other),
                     "step": torch.zeros((), dtype=torch.int32)})
        with use_mesh(other):
            (p2, s2), manifest = CheckpointManager(
                d, async_write=False, specs=specs).restore(template)
        whole = lambda t, m: lm.unshard_params(t, cfg, m)  # noqa: E731
        return {"saved": (whole(new, mesh), whole(state["m"], mesh),
                          whole(state["v"], mesh), state["step"]),
                "loaded": (whole(p2, other), whole(s2["m"], other),
                           whole(s2["v"], other), s2["step"]),
                "step": manifest["step"],
                "files": sorted(os.listdir(d))}

    if "_state" in out:
        case("ckpt", ckpt)

    def kv():
        cfg = kv_config()
        kmesh = Mesh((1, WORLD), ("data", "model"), cpu)
        kb = {"tokens": inp["kv_tokens"], "labels": inp["kv_tokens"]}
        loss, _, new, _, grads = _step(inp["kv_params"], kb, cfg, kmesh)
        one = _step_unsharded(inp["kv_params"], kb, cfg)
        return {"loss": loss, "params": lm.unshard_params(new, cfg, kmesh),
                "grads": lm.unshard_params(grads, cfg, kmesh), "one": one}

    case("kv", kv)
    case("bst", lambda: _bst(inp, mesh))
    for arch in GNN_ARCHS:
        case(f"gnn/{arch}", lambda arch=arch: _gnn(arch, inp, mesh))

    for arch, (mesh_shape, chaos) in LAUNCH.items():
        def launch(arch=arch, mesh_shape=mesh_shape, chaos=chaos):
            carried = inp[f"launch_params/{arch}"]
            ptrain.lm.init_params = lambda gen, cfg: carried
            a = LAUNCH_ARGS
            argv = ["--arch", arch, "--smoke", "--steps", str(a["steps"]),
                    "--batch", str(a["batch"]), "--seq", str(a["seq"]),
                    "--lr", str(a["lr"]), "--device", "cpu", "--ckpt-dir",
                    os.path.join(out_dir, f"ckpt_{arch}"), "--ckpt-every",
                    str(a["ckpt_every"])]
            if chaos:
                argv.append("--chaos")
            loss, report = ptrain.main(argv, mesh=mesh_shape and Mesh(
                mesh_shape, ("data", "model"), cpu))
            return {"loss": float(loss), "report": report,
                    "files": sorted(os.listdir(
                        os.path.join(out_dir, f"ckpt_{arch}")))}

        case(f"launch/{arch}", launch)

    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, s, o = sys.argv[1:5]
    main(int(r), int(w), s, o)
