"""dpc-graph — the paper's *unstructured* workload: connected components on
edge-list meshes (paper §5: CC "in distributed structured and unstructured
grids, based either on the connectivity of the underlying mesh or a feature
mask").

The port's copy of `repro/configs/dpc_graph.py`'s `DPCGraphConfig`,
`SHAPES`, `SMOKE_SHAPES` and `SCALING_PARTS` (it imports nothing of the JAX
package).  Two mesh families:
  * tet_* / geometry_* — the Kuhn/Freudenthal tetrahedralization of an n^3
    grid emitted as a fully unstructured edge list (connectivity 14,
    `data.graphs.grid_edge_list`), a synthetic tet mesh with a known
    oracle; `geometry_*` runs the mask=ones pure-geometry variant;
  * random_* — random sparse graphs (`data.graphs.random_csr`), the
    adversarial partition-adjacency case.

The vertex partition of the distributed runs (`core.distributed_graph`)
is 1-D: contiguous global-id blocks over the flattened device mesh, padded
where the vertex count does not divide (deviation (p) in DESIGN.md).
"""
import dataclasses

FAMILY = "dpc_graph"


@dataclasses.dataclass(frozen=True)
class DPCGraphConfig:
    name: str = "dpc-graph"
    connectivity: int = 14            # Freudenthal/tet edge set (3-D grids)
    threshold_quantile: float = 0.9   # paper's "top 10%" feature mask
    arch: str = "dpc_graph"
    # §Perf (DESIGN.md): drop the redundant mask all_gather (M = T >= 0)
    gather_mask: bool = True


SHAPES = {
    "tet_64": {"kind": "graph_cc", "dims": (64, 64, 64)},
    "tet_32": {"kind": "graph_cc", "dims": (32, 32, 32)},
    "geometry_32": {"kind": "graph_cc", "dims": (32, 32, 32),
                    "geometry": True},
    "random_1m": {"kind": "graph_cc_random", "n": 1 << 20, "avg_degree": 8},
    # prime vertex count: an imbalanced (padded) partition on every mesh
    "tet_ragged": {"kind": "graph_cc", "dims": (61, 43, 29)},
}

# smoke vertex counts need not divide the flat meshes (padded owned sets,
# deviation (p) in DESIGN.md); tet_ragged keeps a prime count
SMOKE_SHAPES = {
    "tet_64": {"kind": "graph_cc", "dims": (8, 8, 8)},
    "tet_32": {"kind": "graph_cc", "dims": (8, 8, 8)},
    "geometry_32": {"kind": "graph_cc", "dims": (8, 8, 8), "geometry": True},
    "random_1m": {"kind": "graph_cc_random", "n": 4096, "avg_degree": 8},
    "tet_ragged": {"kind": "graph_cc", "dims": (7, 7, 7)},
}

# partition counts exercised by the graph-CC strong-scaling benchmark
SCALING_PARTS = (1, 2, 4, 8)


def full_config() -> DPCGraphConfig:
    return DPCGraphConfig()


def smoke_config() -> DPCGraphConfig:
    return DPCGraphConfig(name="dpc-graph-smoke")
