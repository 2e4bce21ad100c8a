"""Neural operators as ``torch.nn`` modules: the SFNO (FNO3d is still to port)."""

from tpu_cfd_torch.models.base import (
    LayerNormnd,
    PointwiseFFN,
    SpectralConv,
    get_activation,
    init_like_flax,
)
from tpu_cfd_torch.models.sfno import (
    SFNO,
    HelmholtzProjection,
    LiftingOperator,
    OutConv,
    SpaceTimePositionalEncoding,
    SpectralConvS,
    SpectralConvT,
    num_parameters,
)
