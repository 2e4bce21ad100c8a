"""Data parallelism over ``torch.distributed``: meshes, batch shards and the
CLIs' launch rule (counterpart of ``tpu_cfd/parallel``)."""

from tpu_cfd_torch.parallel.launch import launch
from tpu_cfd_torch.parallel.mesh import (
    all_ranks,
    gather_batch,
    make_mesh,
    replicate,
    sfno_param_spec,
    shard_batch,
    shard_field_spatial,
    shard_params,
)
