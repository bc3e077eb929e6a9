"""DPC inside a GNN data pipeline on the PyTorch/CUDA port (the twin of
`examples/gnn_cc_pipeline.py`):

1. build a large synthetic graph, sample minibatches with the CSR fanout
   sampler (the minibatch_lg cell's pipeline);
2. label every sampled subgraph's connected components with DPC-CC
   (`repro_torch.core.connected_components_graph`) — the pipeline sanity
   metric;
3. train a GAT for a few steps on the samples (`models.gnn.loss_fn` under
   autograd, AdamW).

The graph, the samples and so the component counts are JAX's, bit for
bit; the GAT's weights are drawn from a `torch.Generator`.  Runs on the
CUDA card unless `--device cpu` is given:

  PYTHONPATH=src python examples/gnn_cc_pipeline_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.interop import gnn_batch_from_numpy  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def main(argv=None):
    """Runs the pipeline; returns one record a step: {"nodes",
    "components", "loss", "acc"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, deg = 20_000, 12
    indptr, indices = graphs.random_csr(n, deg, seed=1)
    feats = rng.standard_normal((n, 32)).astype(np.float32)
    labels = rng.integers(0, 7, n)
    sampler = graphs.NeighborSampler(indptr, indices, fanouts=(5, 3), seed=2)

    cfg = gnn.GATConfig(d_in=32, n_classes=7, d_hidden=8, n_heads=4)
    params = gnn.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw(3e-3)
    state = opt.init(params)

    def step(params, state, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, aux = gnn.loss_fn(leaves, batch, cfg)
        loss.backward()
        params, state, _ = opt.update(tree_map(lambda t: t.grad, leaves),
                                      state, params)
        return params, state, float(loss.detach()), float(aux["acc"])

    records = []
    for i in range(args.steps):
        b = graphs.sampled_batch(sampler, feats, labels, batch_nodes=128,
                                 step=i)
        # DPC-CC pipeline check: how fragmented is this sample?
        cc = graphs.component_labels(b, dev)
        n_comp = len(np.unique(cc[cc >= 0]))
        params, state, loss, acc = step(params, state,
                                        gnn_batch_from_numpy(b, dev))
        nodes = int(b["node_mask"].sum())
        records.append({"nodes": nodes, "components": n_comp, "loss": loss,
                        "acc": acc})
        print(f"step {i}: sampled {nodes} nodes in {n_comp} DPC components "
              f"| loss {loss:.4f} acc {acc:.3f}")
    print("OK")
    return records


if __name__ == "__main__":
    main()
