"""Neural operators as ``torch.nn`` modules: the SFNO and the FNO3d baseline.

Counterpart of ``tpu_cfd/models``. Two of its names are functions of a flax
parameter tree there and are the module's own here:
``apply_with_latents(model, params, ...)`` is ``forward_with_latents(model,
...)``, and ``params_to_double(params)`` is ``model.double()``
(``torch.nn.Module.double``).
"""

from tpu_cfd_torch.models.base import (
    LayerNormnd,
    PointwiseFFN,
    SpectralConv,
    forward_with_latents,
    get_activation,
    init_like_flax,
)
from tpu_cfd_torch.models.fno3d import (
    FNO3d,
    MLP3d,
    SpectralConv3d,
    add_grid_3d,
    make_fno3d_input,
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
