"""Multi-resolution SFNO inference shapes, latent taps and eval latency.

Counterpart of ``examples/check_sfno_shapes.py`` (the reference's
``examples/check_SFNO_shapes.py``): one SFNO (modes 16/16/5, width 20, 10
latent steps, 4 layers) maps inputs of any mesh and length to outputs of
any length; its named latents come from ``models.forward_with_latents``
(where the JAX example captures flax intermediates, which add three method
outputs of each SpectralConvS to the same five named latents); and the mean
time of 100 forwards at 128² x 10 steps, timed with CUDA events on the card.

Runs on the card unless ``--no-cuda`` asks for the CPU:
  python -m tpu_cfd_torch.examples.check_sfno_shapes
"""

from __future__ import annotations

import argparse
import time

import torch

from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, forward_with_latents, init_like_flax, num_parameters

# (n, t_in, t_out): arbitrary space-time discretizations in and out; t_in is
# at least the latent steps (the reference's sfno.py:254)
SHAPES = ((64, 10, 10), (64, 10, 40), (128, 12, 10), (256, 10, 10))


def build(width: int = 20) -> SFNO:
    return SFNO(modes_x=16, modes_y=16, modes_t=5, width=width, latent_steps=10,
                num_spectral_layers=4)


@torch.no_grad()
def output_shapes(model: SFNO, shapes, device, generator: torch.Generator) -> dict:
    """``{(n, t_in, t_out): output shape}`` of one forward of a (1, n, n,
    t_in) input each."""
    out = {}
    for n, t_in, t_out in shapes:
        v = torch.randn((1, n, n, t_in), generator=generator).to(device)
        out[(n, t_in, t_out)] = tuple(model(v, out_steps=t_out).shape)
        print(f"in (1, {n:>3}, {n:>3}, {t_in:>2}) -> out {out[(n, t_in, t_out)]}")
    return out


def main(argv=None) -> dict:
    """Runs the example; returns ``{"n_params", "shapes", "latents" ({name:
    shape}), "ms_per_forward", "forwards" ((batch, n) of every forward, in
    order)}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=20)
    p.add_argument("--iters", type=int, default=100, help="timed forwards at 128²")
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)

    model = init_like_flax(build(args.width), torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator().manual_seed(0)
    n_params = num_parameters(model)
    print(f"SFNO parameters: {n_params / 1e6:.2f}M")
    shapes = output_shapes(model, SHAPES, device, gen)
    forwards = [(1, n) for n, _, _ in SHAPES]

    with torch.no_grad():
        v64 = torch.randn((2, 64, 64, 10), generator=gen).to(device)
        _, latents = forward_with_latents(model, v64)
        forwards.append((2, 64))
        latents = {k: tuple(v.shape) for k, v in latents.items()}
        print(f"captured {len(latents)} latent tensors: {latents}")

        # eval latency: the mean of the timed forwards at 128^2 x 10 steps
        v128 = torch.randn((1, 128, 128, 10), generator=gen).to(device)
        model(v128)
        forwards += [(1, 128)] * (args.iters + 1)
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.iters):
                model(v128)
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / args.iters
        else:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(v128)
            ms = 1e3 * (time.perf_counter() - t0) / args.iters
    print(f"eval latency 128^2 x 10 on {device}: {ms:.2f} ms/forward")
    return {"n_params": n_params, "shapes": shapes, "latents": latents,
            "ms_per_forward": ms, "forwards": forwards}


if __name__ == "__main__":
    main()
