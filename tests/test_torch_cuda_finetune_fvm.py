"""The fp64 fine-tune pipeline and the FVM solver on the card against the CPU.

Imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest -m cuda tests/test_torch_cuda_finetune_fvm.py`` on a
machine with a card. Everywhere else each test skips. The fine-tune path
runs no hand-written kernel: there the comparison holds cuFFT and cuBLAS
against the CPU's libraries. The FVM step runs each explicit evaluation as
one launch of the hand-written kernel ``ops/cuda/fvm_explicit.py`` and its
projection on cuFFT, against the CPU's plain PyTorch path and pocketfft.
Tolerances, as ``chip_smoke.py`` phases 12 and 13 state
them: ``fine_tune_post``'s fields within 1e-8 of the largest ∂w/∂t (fp64
roundoff over dt = 1e-6), the residual norm and one Adam step's gradients
at dt 1e-3 within 1e-8; the FVM velocity after 20 classic-RK4 steps within
1e-10 of its largest entry.
"""

import math

import pytest
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.ops import finite_differences as fdm
from tpu_cfd_torch.solvers import forcings, fvm, initial_conditions as ic
from tpu_cfd_torch.solvers import trajectories
from tpu_cfd_torch.train import finetune, losses

pytestmark = pytest.mark.cuda

N, NT = 64, 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_cuda_finetune_fvm.py)")
    return torch.device("cuda")


def _trajectory():
    """(1, N, N, NT) fp64 solver trajectory from a seeded IC, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    grid = grids.Grid((N, N), domain=((0, 1), (0, 1)))
    w0 = ic.vorticity_field(grid, 4, dtype=torch.float64,
                            noise=torch.randn((N, N), dtype=torch.float64, generator=gen)).data
    out = trajectories.get_trajectory_imex_crank_nicolson(
        w0, torch.zeros_like(w0), visc=1e-3, T=0.06, delta_t=1e-3, record_steps=NT)
    return torch.movedim(out["vorticity"], 0, -1)[None]


def _rel(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())


def test_fine_tune_post_card_vs_cpu(dev):
    w = _trajectory()
    kw = dict(visc=1e-3, dt=1e-6, diam=1.0, bdf_weight=(0.5, 0.5))
    cpu = finetune.fine_tune_post(w, None, **kw)
    card = finetune.fine_tune_post(w.to(dev), None, **kw)
    scale = float(cpu["w_t"].abs().max())
    for k in cpu:
        assert card[k].device.type == dev.type and card[k].dtype == torch.float64
        assert float((card[k].cpu() - cpu[k]).abs().max()) < 1e-8 * scale, k


def test_outconv_ft_norm_and_gradients_card_vs_cpu(dev):
    w = _trajectory()
    norm = losses.SobolevLoss(n_grid=N, norm_order=-1, relative=False, time_average=True,
                              alpha=10 ** (-3 / 2), freq_cutoff=N // 2 + 1, diam=1.0)
    conv = finetune.OutConvFT(8, 8, 3, out_steps=NT).conv
    conv.reset_parameters(torch.Generator().manual_seed(1))
    got = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        m = finetune.build_finetune_outconv(
            conv, (8, 8, 3), (16, 16, 4), out_steps=NT,
            generator=torch.Generator().manual_seed(2), dtype=torch.float64, device=d,
            delta=1.0, diam=1.0, visc=1e-3, dt=1e-3, bdf_weight=(0.5, 0.5))
        loss = norm(m(w[..., None].to(d), w.to(d), None, out_steps=NT)["residual"])
        loss.backward()
        got[where] = (loss.detach().cpu(), {k: p.grad for k, p in m.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["card"]
    assert abs(float(l_card - l_cpu)) < 1e-8 * float(l_cpu)
    for k, g in g_cpu.items():
        assert _rel(g_card[k], g) < 1e-8, k


def test_fvm_card_vs_cpu(dev):
    grid = grids.Grid((N, N), domain=((0, 2 * math.pi), (0, 2 * math.pi)))
    noise = torch.randn((2, N, N), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(42))
    ends = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        v = ic.filtered_velocity_field(grid, 3.0, 3, iterations=3, dtype=torch.float64,
                                       noise=noise, device=d)
        eqn = fvm.NavierStokes2DFVMProjection(
            viscosity=1e-3, grid=grid, drag=0.1, dtype=torch.float64,
            forcing=forcings.KolmogorovForcing(grid=grid, diam=2 * math.pi, wave_number=3,
                                               offsets=(v[0].offset, v[1].offset)),
            solver=fvm.RKStepper.from_method("classic_rk4"))
        for _ in range(20):
            v = eqn(v, 1e-2)
        assert float(fdm.divergence(v).data.abs().max()) < 1e-12
        ends[where] = v
    for a, b in zip(ends["card"], ends["cpu"]):
        assert a.data.device.type == dev.type
        assert _rel(a.data, b.data) < 1e-10
