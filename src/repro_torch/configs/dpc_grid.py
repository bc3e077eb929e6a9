"""dpc-grid — the paper's own workload: Morse-Smale segmentation and
connected components of Perlin-noise structured grids (paper §5).

The port's copy of `repro/configs/dpc_grid.py`'s `DPCConfig` and `SHAPES`
(it imports nothing of the JAX package).  The single-device slice runs
`grid_512` (MS) and `cc_512` (CC of the top-10% mask) on one card: 512^3 on
one device is the per-device share of the paper's largest run (4096^3 over
64 nodes puts 1024^3 on a node).  1024^3 is the largest grid whose flat ids
fit int32 (2048^3+ takes the int64 path).

`layout` is the block decomposition of the distributed runs; the cells
(`launch.cells`) fall back to the flat 1-D mesh when it does not match the
rank count."""
import dataclasses

FAMILY = "dpc"


@dataclasses.dataclass(frozen=True)
class DPCConfig:
    name: str = "dpc-grid"
    connectivity: int = 6
    threshold_quantile: float = 0.9   # paper's "top 10%" feature mask
    arch: str = "dpc"
    # the CC boundary mask equals (labels >= 0); gather_mask=False drops the
    # redundant mask all_gather from the ONE exchange
    gather_mask: bool = True
    layout: tuple = (8, 8, 4)         # 256 chips, one pod


SHAPES = {
    "grid_512": {"kind": "dpc", "dims": (512, 512, 512)},
    "grid_1024": {"kind": "dpc", "dims": (1024, 1024, 1024)},
    "cc_1024": {"kind": "dpc_cc", "dims": (1024, 1024, 1024)},
    "cc_512": {"kind": "dpc_cc", "dims": (512, 512, 512)},
    # prime extents: the paper's real datasets are not multiples of the
    # node count
    "grid_ragged": {"kind": "dpc", "dims": (971, 613, 431)},
    "cc_ragged": {"kind": "dpc_cc", "dims": (971, 613, 431)},
}

# smoke grids (JAX's): small enough to trace fast; ragged shapes keep their
# prime extents
SMOKE_SHAPES = {
    "grid_512": {"kind": "dpc", "dims": (512, 8, 8)},
    "grid_1024": {"kind": "dpc", "dims": (1024, 8, 8)},
    "cc_1024": {"kind": "dpc_cc", "dims": (1024, 8, 8)},
    "cc_512": {"kind": "dpc_cc", "dims": (512, 8, 8)},
    "grid_ragged": {"kind": "dpc", "dims": (97, 61, 43)},
    "cc_ragged": {"kind": "dpc_cc", "dims": (97, 61, 43)},
}


def full_config() -> DPCConfig:
    return DPCConfig()


def smoke_config() -> DPCConfig:
    return DPCConfig(name="dpc-grid-smoke", layout=(2, 2, 2))
