"""Solver runtime: equations, time steppers, the finite-volume solver,
forcings, initial conditions, the pressure projection, and trajectory
rollout."""

from tpu_cfd_torch.solvers.equations import (
    IMEXStepper,
    ImplicitExplicitODE,
    NavierStokes2DSpectral,
    RK4CrankNicolsonStepper,
    stable_time_step,
)
from tpu_cfd_torch.solvers.fvm import (
    NavierStokes2DFVMProjection,
    ProjectionExplicitODE,
    RKStepper,
)
from tpu_cfd_torch.solvers.forcings import (
    ForcingFn,
    KolmogorovForcing,
    SimpleSolenoidalForcing,
    SinCosForcing,
)
from tpu_cfd_torch.solvers.initial_conditions import (
    filtered_velocity_field,
    vorticity_field,
)
from tpu_cfd_torch.solvers.pressure import PressureProjection, Pseudoinverse, projection
from tpu_cfd_torch.solvers.trajectories import (
    get_trajectory_imex,
    get_trajectory_imex_crank_nicolson,
    imex_crank_nicolson_step,
    update_residual,
)
