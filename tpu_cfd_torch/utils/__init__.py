"""Utilities: determinism, timing, parameter counting, config introspection,
profiling and plots.

Counterpart of ``tpu_cfd/utils``. Device-memory inspection (the reference's
``dump_tensors``) is ``profiling.device_memory_summary``.
"""

from tpu_cfd_torch.utils.tools import (
    check_nan,
    clones,
    get_config,
    get_num_params,
    get_seed,
    get_size,
    timer,
)
from tpu_cfd_torch.utils.profiling import (
    device_memory_summary,
    profile_to,
    trace_annotation,
)
