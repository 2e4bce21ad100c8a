"""tpu_cfd_torch: the PyTorch and CUDA port of ``tpu_cfd`` for NVIDIA Hopper.

A package beside the JAX one, held against it by the tests. It imports
``torch`` and never ``jax`` nor anything of ``tpu_cfd``. So far it carries
McWilliams dataset generation by the pseudo-spectral vorticity solver, with
the fused RK4-CN step as hand-written CUDA kernels
(``ops/cuda/csrc/spectral_step.cu``), SFNO training (``models``,
``train``), with the truncated 2-D DFT pair and the pointwise FFN as
hand-written CUDA kernels (``ops/cuda/csrc/spectral_conv.cu``, ``ffn.cu``),
the optimizer sweep of the SFNO train step with the one-pass Adam update as
a hand-written CUDA kernel (``train/opt_layout.py``, ``adam.cu``), FNO3d
baseline training (``models/fno3d.py``, ``train/train_fno3d.py``), and the
Kolmogorov and FNO datasets (``data/generate.py``) with the pieces of the
finite-volume stack that their initial conditions need: the grid data model
and boundary conditions, finite differences, fast diagonalization and the
pressure projection (``solvers/pressure.py``), and the GRF sampler
(``data/grf.py``); a-posteriori fine-tuning (``train/finetune.py``) and the
FVM solver (``solvers/fvm.py``); data parallelism over ``torch.distributed``
behind both CLIs' ``--data-parallel`` (``parallel/``), the utilities
(``utils/``) and the examples (``examples/``).
"""

__version__ = "0.1.0"

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.grids import (
    Grid,
    GridArray,
    GridArrayTensor,
    GridArrayVector,
    GridVariable,
    GridVariableVector,
    applied,
)
from tpu_cfd_torch.boundaries import (
    BCType,
    ConstantBoundaryConditions,
    HomogeneousBoundaryConditions,
    periodic_boundary_conditions,
)
