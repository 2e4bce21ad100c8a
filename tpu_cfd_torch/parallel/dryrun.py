"""The port's multi-rank dry run, counterpart of
``__graft_entry__.dryrun_multichip(n)``.

``python -m tpu_cfd_torch.parallel.dryrun`` on the card (under
``torch.distributed.run``, or spawning one worker a visible card), or
``--no-cuda --world N`` as N gloo ranks on the CPU. Like JAX's, it makes a
``(data, model)`` mesh with ``model_parallel`` 2 where the world is even and
at least 4, else 1, and runs each leg at JAX's tiny shapes (16², SFNO width
8, modes 4/4/2, 2 layers, batch 2 × data):

1. ``train_step``: the dp × tp SFNO train step (``SobolevLoss(norm_order=-1,
   relative=True)``, Adam 1e-3) against the unsharded step on every rank;
2. ``epoch``: the data-parallel epoch trainer (``pipeline.make_device_epoch``,
   DDP over ``data``) against the unsharded epoch;
3. ``solver``: the batch-sharded solver step against the unsharded one;
4. ``recorded_rollout``: the data-parallel recorded rollout on
   ``dft_galerkin``;
5. ``fused_rollout``: the fused aligned rollout on each rank's batch shard
   against the plain aligned solver (the CUDA kernels on the card);
6. ``pencil`` (``model_parallel`` > 1): the pencil-sharded solver step against
   the batch-sharded one, compared as complex numbers;
7. ``finetune``: the data-parallel fine-tune against the unsharded one.

Each leg raises on a mismatch, with the JAX tests' tolerances, so the run
exits non-zero; rank 0 prints each leg's ms and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tpu_cfd_torch import grids
from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
from tpu_cfd_torch.models import SFNO, forward_with_latents, init_like_flax
from tpu_cfd_torch.parallel import (average_gradients, gather_parameters, make_mesh,
                                    mean_over, replicate, shard_batch,
                                    shard_field_spatial, shard_params)
from tpu_cfd_torch.parallel.launch import launch
from tpu_cfd_torch.solvers import trajectories
from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral
from tpu_cfd_torch.train import finetune, losses
from tpu_cfd_torch.train.pipeline import make_device_epoch

N_GRID, WIDTH, T_WIN, DT = 16, 8, 4, 1e-3
# a collective that waits longer fails the run instead of hanging it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def close(got, want, rtol: float, atol: float, what: str) -> None:
    """Raises where ``got`` and ``want`` differ beyond ``rtol``/``atol``
    (``torch.allclose``; complex tensors as complex numbers)."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"dryrun {what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"dryrun {what}: differs by up to {err:.3e} "
                             f"(rtol {rtol}, atol {atol})")


def _sfno(device, **kw) -> SFNO:
    model = SFNO(modes_x=4, modes_y=4, modes_t=2, width=WIDTH, num_spectral_layers=2,
                 **kw)
    return init_like_flax(model, torch.Generator().manual_seed(0)).to(device)


def _normal(seed: int, shape, device) -> torch.Tensor:
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


def run(device, log=print) -> dict:
    """Every leg on the process group that is up; returns each leg's ms."""
    world = dist.get_world_size()
    model_parallel = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(model_parallel=model_parallel)
    n_data = world // model_parallel
    batch = n_data * 2
    device = torch.device(device)
    rows = {}

    @contextlib.contextmanager
    def leg(name: str):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rows[name] = 1e3 * (time.perf_counter() - t0)
        log(f"dryrun: {name} ok in {rows[name]:.1f} ms")

    loss_obj = losses.SobolevLoss(n_grid=N_GRID, norm_order=-1, relative=True)

    def train_step(model, opt, v, y, sharded):
        opt.zero_grad(set_to_none=True)
        loss = loss_obj(model(v), y)
        loss.backward()
        if sharded:
            average_gradients(model.parameters(), mesh)
            loss = mean_over(loss, mesh)
        opt.step()
        return loss.detach()

    with leg("train_step"):
        v = _normal(0, (batch, N_GRID, N_GRID, 6), device)
        y = _normal(1, (batch, N_GRID, N_GRID, 6), device)
        ref = _sfno(device, latent_steps=4)
        tp = copy.deepcopy(ref)
        loss_ref = train_step(ref, torch.optim.Adam(ref.parameters(), lr=1e-3), v, y, False)
        shard_params(tp, mesh)
        loss = train_step(tp, torch.optim.Adam(tp.parameters(), lr=1e-3),
                          shard_batch(v, mesh), shard_batch(y, mesh), True)
        close(loss, loss_ref, 1e-6, 0.0, "train_step loss")
        got = gather_parameters(tp)
        for k, p in ref.named_parameters():
            close(got[k], p.detach(), 1e-5, 1e-6, f"train_step parameter {k}")

    with leg("epoch"):
        traj = np.random.default_rng(3).normal(size=(batch, 3 * T_WIN, N_GRID, N_GRID))
        ds = SpatioTemporalDataset({"vorticity": traj.astype(np.float32)}, n_samples=batch,
                                   steps=T_WIN, out_steps=T_WIN, fields=["vorticity"])
        data = torch.from_numpy(ds.data["vorticity"]).to(device)
        model_ep = _sfno(device, latent_steps=T_WIN, output_steps=T_WIN)
        single = copy.deepcopy(model_ep)
        replicate(model_ep, mesh)
        net = DistributedDataParallel(
            model_ep, process_group=mesh.get_group("data"),
            device_ids=[device.index] if device.type == "cuda" else None)
        idx, starts = ds.epoch_indices(n_data, np.random.default_rng(0))
        ls = make_device_epoch(net, loss_obj, torch.optim.Adam(net.parameters(), lr=1e-3),
                               data, T_WIN, T_WIN, mesh=mesh)(idx, starts)
        ls_ref = make_device_epoch(single, loss_obj,
                                   torch.optim.Adam(single.parameters(), lr=1e-3),
                                   data, T_WIN, T_WIN)(idx, starts)
        close(ls, ls_ref, 1e-5, 0.0, "epoch losses")
        for (k, p), q in zip(model_ep.named_parameters(), single.parameters()):
            close(p.detach(), q.detach(), 2e-4, 2e-6, f"epoch parameter {k}")

    grid = grids.Grid((N_GRID, N_GRID), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, device=device)
    what = torch.fft.rfft2(_normal(2, (batch, N_GRID, N_GRID), device))
    with leg("solver"):
        out_ref = ns.forward(what, DT, steps=2)[0]
        out = ns.forward(shard_batch(what, mesh), DT, steps=2)[0]
        close(out, shard_batch(out_ref, mesh), 1e-6, 1e-8, "batch-sharded solver step")

    with leg("recorded_rollout"):
        ns_g = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_galerkin",
                                      device=device)

        def record(w):
            return trajectories.get_trajectory_imex(
                ns_g, w, DT, num_steps=4, record_every_steps=2,
                fields=("vorticity",))["vorticity"]

        recs = record(shard_batch(what, mesh))
        want = shard_batch(record(what), mesh)
        if recs.shape[-3] != 2:
            raise AssertionError(f"dryrun recorded_rollout: {recs.shape[-3]} records, not 2")
        close(recs, want, 0.0, 1e-5 * float(want.abs().max()), "recorded rollout")

    with leg("fused_rollout"):
        ns_f = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_aligned",
                                      fused=True, device=device)
        ns_a = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_aligned",
                                      device=device)
        w_al = ns_f._align(shard_batch(what, mesh))
        close(ns_f.forward(w_al, DT, steps=2)[0], ns_a.forward(w_al, DT, steps=2)[0],
              1e-4, 1e-5, "fused aligned rollout against the plain aligned solver")

    if model_parallel > 1:
        with leg("pencil"):
            pencil = shard_field_spatial(what, mesh, spatial_axis=-2)
            out_p = ns.forward(pencil, DT, steps=2)[0].to_local()
            rows_ref = torch.chunk(out_ref, model_parallel, dim=-2)[
                mesh.get_local_rank("model")]
            close(out_p, rows_ref, 1e-4, 1e-4, "pencil-sharded solver step")

    with leg("finetune"):
        w_in = _normal(5, (batch, N_GRID, N_GRID, T_WIN), device)
        with torch.no_grad():
            _, latents = forward_with_latents(model_ep, w_in, out_steps=T_WIN)
        v_latent = latents["r"]

        def outconv():
            return finetune.build_finetune_outconv(
                model_ep.out_conv.conv, (4, 4, 2), (5, 5, 2), out_steps=T_WIN,
                generator=torch.Generator().manual_seed(7), device=device, visc=1e-3,
                dt=1e-6, diam=1.0, finetune=True)

        ft_ref, ft_sh = outconv(), replicate(outconv(), mesh)
        hist_ref = finetune.finetune_steps(ft_ref, v_latent, w_in, None, out_steps=T_WIN,
                                           n_steps=2, lr=1e-3)
        hist_sh = finetune.finetune_steps(ft_sh, shard_batch(v_latent, mesh),
                                          shard_batch(w_in, mesh), None, out_steps=T_WIN,
                                          n_steps=2, lr=1e-3, mesh=mesh)
        close(torch.tensor(hist_sh), torch.tensor(hist_ref), 1e-5, 1e-7,
              "data-parallel fine-tune residuals")
        for (k, p), q in zip(ft_sh.named_parameters(), ft_ref.parameters()):
            close(p.detach(), q.detach(), 1e-5, 1e-7, f"data-parallel fine-tune {k}")
    return {"world": world, "mesh": {"data": n_data, "model": model_parallel},
            "legs_ms": rows}


def _main_in_group(argv: Optional[List[str]]) -> dict:
    args = _parser().parse_args(argv)
    if args.no_cuda:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = dist.get_rank() == 0
    out = run(device, log=print if rank0 else (lambda *a: None))
    if rank0:
        print(json.dumps({"dryrun": out}), flush=True)
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU (gloo)")
    p.add_argument("--world", type=int, default=None,
                   help="with --no-cuda: the number of gloo ranks to spawn")
    return p


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if dist.is_initialized():
        return _main_in_group(argv)
    if not args.no_cuda and args.world is not None:
        raise SystemExit("--world is for --no-cuda; on the card the world is one rank a "
                         "visible card (or torch.distributed.run's)")
    return launch(_main_in_group, argv, cuda=not args.no_cuda, world=args.world,
                  timeout=COLLECTIVE_TIMEOUT)


if __name__ == "__main__":
    main()
