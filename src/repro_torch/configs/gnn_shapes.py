"""Shared GNN-family shape set (copy of `repro/configs/gnn_shapes.py`).
Sizes are the assigned cells; sampled shapes (minibatch_lg) list both the
source-graph size and the padded per-batch sample sizes the sampler
guarantees."""

SHAPES = {
    "full_graph_sm": {
        "kind": "full", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
        "n_classes": 7,
    },
    "minibatch_lg": {
        "kind": "sampled", "n_nodes": 232_965, "n_edges": 114_615_892,
        "batch_nodes": 1024, "fanout": (15, 10), "d_feat": 602,
        "n_classes": 41,
        # padded sample sizes: 1024*(1+15+150) nodes, 2*1024*(15+150) edges
        "sample_nodes": 169_984, "sample_edges": 337_920,
    },
    "ogb_products": {
        "kind": "full", "n_nodes": 2_449_029, "n_edges": 61_859_140,
        "d_feat": 100, "n_classes": 47,
    },
    "molecule": {
        "kind": "batched", "n_nodes": 30, "n_edges": 64, "batch": 128,
    },
}

# smoke shapes are multiples of 512 on sharded dims so `dryrun --smoke`
# exercises the identical sharding paths on the production meshes
SMOKE_SHAPES = {
    "full_graph_sm": {"kind": "full", "n_nodes": 1024, "n_edges": 4096,
                      "d_feat": 16, "n_classes": 7},
    "minibatch_lg": {"kind": "sampled", "n_nodes": 2048, "n_edges": 16384,
                     "batch_nodes": 128, "fanout": (3, 2), "d_feat": 16,
                     "n_classes": 7, "sample_nodes": 1536,
                     "sample_edges": 2048},
    "ogb_products": {"kind": "full", "n_nodes": 1024, "n_edges": 4096,
                     "d_feat": 16, "n_classes": 7},
    "molecule": {"kind": "batched", "n_nodes": 16, "n_edges": 32,
                 "batch": 64},
}
