"""Scale-out of the port (port of timeopt_tpu/parallel/): the batch and the
terminal queries split over the devices of one process (mesh.py; on
cards its batch chunks' captured programs run at once), batch statistics
reduced across processes (stats.py), and the multi-process runtime on
torch.distributed (distributed.py): one rank a card."""

from timeopt_tpu_torch.parallel import distributed
from timeopt_tpu_torch.parallel.mesh import (
    make_mesh,
    propagator_select_sharded,
    shard_problems,
    solve_batch_resident,
    solve_batch_sharded,
)
from timeopt_tpu_torch.parallel.stats import batch_summary, t_star_histogram

__all__ = [
    "make_mesh",
    "shard_problems",
    "solve_batch_resident",
    "solve_batch_sharded",
    "propagator_select_sharded",
    "t_star_histogram",
    "batch_summary",
    "distributed",
]
