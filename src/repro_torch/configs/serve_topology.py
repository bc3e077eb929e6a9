"""serve-topology — configuration of the batched multi-tenant topology
query engine (`repro_torch.serve.TopologyEngine`, DESIGN.md §Serve).

The port's copy of `repro/configs/serve_topology.py` (it imports nothing of
the JAX package).  Not an ARCH_IDS member: this config parameterises the serving layer that
fronts the dpc_grid / dpc_graph workloads, not a model architecture.  The
`shapes` rotate prime and non-divisible extents on purpose so the workload
exercises the layout-bucketing path the way real datasets do.
"""
import dataclasses

FAMILY = "serve"


@dataclasses.dataclass(frozen=True)
class ServeTopologyConfig:
    name: str = "serve-topology"
    connectivity: int = 6
    # engine knobs
    min_extent: int = 8        # bucket floor: smallest padded grid extent
    max_batch: int = 64        # largest batch capacity per execution
    cache_capacity: int = 64   # bounded LRU on compiled executables
    slot_cost_cells: int = 0   # layout-merge cost model (0 disables;
                               # DESIGN.md §Serve-v2)
    # synthetic workload mix (query, weight) for benchmarks / demos
    mix: tuple = (("cc", 0.5), ("ms", 0.2), ("manifold", 0.1),
                  ("threshold_sweep", 0.2))
    table_mode: str = "replicated"  # boundary-table layout for distributed
                                    # requests ("sharded" = deviation (s))
    table_max_iter: int = 64
    # request extents: prime / non-divisible on purpose (bucketing path)
    shapes: tuple = ((96, 96, 96), (97, 61, 43), (64, 96, 48), (101, 53, 37))
    sweep_k: int = 4           # thresholds per sweep request
    # async plane (open-loop arrivals; DESIGN.md §Serve-v2)
    rate: float = 50.0         # Poisson arrival rate, requests per second
    deadline_slack: float = 0.5  # mean request deadline slack, seconds
    # overload plane (admission control / shedding; DESIGN.md §Serve-v3)
    max_queue_depth: int = 1024       # admission budget: queued work items
    max_inflight_cells: int = 256_000_000  # admission budget: queued cells
    shed_policy: str = "never"        # "never" | "late" | "hopeless"
    overload_factor: float = 4.0      # overload smoke: x sustainable rate
    overload_queue_depth: int = 24    # tight budget used by --overload runs


def full_config() -> ServeTopologyConfig:
    return ServeTopologyConfig()


def smoke_config() -> ServeTopologyConfig:
    return ServeTopologyConfig(
        name="serve-topology-smoke", max_batch=16,
        shapes=((17, 13, 11), (13, 11, 7), (16, 12, 8)), sweep_k=3,
        slot_cost_cells=4096, rate=200.0, deadline_slack=0.25,
        max_queue_depth=256, max_inflight_cells=16_000_000,
        overload_queue_depth=16)
