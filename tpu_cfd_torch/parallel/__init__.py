"""Data and tensor parallelism over ``torch.distributed``: meshes, batch
shards, the CLIs' launch rule, the SFNO's and FNO3d's parameters sharded
on the ``model`` axis and pencil-sharded solver fields (counterpart of
``tpu_cfd/parallel``)."""

from tpu_cfd_torch.parallel.launch import launch
from tpu_cfd_torch.parallel.mesh import (
    all_ranks,
    average_gradients,
    gather_batch,
    gather_parameters,
    make_mesh,
    mean_over,
    replicate,
    sfno_layout,
    sfno_param_spec,
    shard_batch,
    shard_field_spatial,
    shard_params,
    sharded_parameters,
)
