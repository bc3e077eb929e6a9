"""Configurations of the port (copies of `repro/configs`'s, so the port reads
no module of the JAX package): the paper's structured-grid workload,
`dpc_grid`, its edge-list one, `dpc_graph`, the serving layer's,
`serve_topology` (`repro_torch.serve`), the LMs (`llama3_2_1b`,
`stablelm_12b`, `minitron_8b`, and the MoE `deepseek_moe_16b` and
`kimi_k2_1t`, `repro_torch.models.lm`), BST (`bst`,
`repro_torch.models.bst`) and the GNNs (`gat_cora`, `schnet`,
`meshgraphnet`, `dimenet`, `repro_torch.models.gnn`, with their shared
`gnn_shapes`).  Each arch module exposes FAMILY, full_config(),
smoke_config() and SHAPES, as in JAX.

`get(arch_id)` takes JAX's ids and aliases.  Every id of ARCH_IDS has its
model in the port, the GNN ids included, so none raises
NotImplementedError.
"""
from importlib import import_module

ARCH_IDS = [
    # LM family (5)
    "stablelm_12b", "llama3_2_1b", "minitron_8b", "deepseek_moe_16b",
    "kimi_k2_1t",
    # GNN (4)
    "gat_cora", "schnet", "meshgraphnet", "dimenet",
    # RecSys (1)
    "bst",
    # the paper's own workloads (structured grid + unstructured graph)
    "dpc_grid",
    "dpc_graph",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({"llama3.2-1b": "llama3_2_1b", "kimi-k2-1t-a32b": "kimi_k2_1t",
               "stablelm-12b": "stablelm_12b", "minitron-8b": "minitron_8b",
               "deepseek-moe-16b": "deepseek_moe_16b",
               "gat-cora": "gat_cora",
               # serving-layer config (not an arch; lives outside ARCH_IDS)
               "serve-topology": "serve_topology"})


def get(arch_id: str):
    """The config module of `arch_id` (an id of ARCH_IDS, an alias such as
    "llama3.2-1b", or "serve_topology")."""
    name = _ALIAS.get(arch_id, arch_id)
    return import_module(f"repro_torch.configs.{name}")
