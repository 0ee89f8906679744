"""Data-parallel and multi-process training and evaluation, and tensor and
sequence parallelism for inference (counterpart of adnm_tpu/parallel/): the
'data', 'seq' and 'model' axes of the JAX package's mesh as ranks of
processes joined by torch.distributed."""

from adnm_tpu_torch.device import rank_device
from adnm_tpu_torch.parallel.mesh import make_mesh, parse_mesh, spawn
from adnm_tpu_torch.parallel.multihost import (
    all_reduce_sum,
    finish_multihost,
    host_barrier,
    init_multihost,
    is_multiprocess,
    launched_by_torchrun,
    rank_and_world,
)
