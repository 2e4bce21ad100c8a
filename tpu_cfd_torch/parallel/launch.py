"""The launch rule of the port's ``--data-parallel`` CLIs.

JAX's ``--data-parallel`` spreads one program over every available device.
The port runs one process a card, so a CLI asked for it, and not yet in a
process group, calls ``launch(main, argv, cuda=...)``, which re-enters
``main(argv)`` inside one:

- under ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` set), it
  joins the world it was given, on card ``LOCAL_RANK``;
- launched plainly on the card, it starts one worker a visible card with
  ``torch.multiprocessing.spawn`` (NCCL over ``tcp://localhost``);
- launched plainly with ``--no-cuda``, it runs a world of one (gloo).

Each rank sets its card before its first tensor. A caller that already holds
a process group (a test, ``chip_smoke.py``) calls ``main`` inside it.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, List, Optional

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(main: Callable, argv: List[str], rank: int, world: int,
         init_method: Optional[str], card: Optional[int]):
    if card is not None:
        torch.cuda.set_device(card)
    if init_method is None:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group("nccl" if card is not None else "gloo",
                                init_method=init_method, rank=rank, world_size=world)
    try:
        return main(argv)
    finally:
        dist.destroy_process_group()


def _worker(rank: int, main: Callable, argv: List[str], world: int,
            init_method: str):
    _run(main, argv, rank, world, init_method, rank)


def launch(main: Callable, argv: List[str], *, cuda: bool):
    """Runs ``main(argv)`` on every rank of a new process group and returns
    its result; after spawned workers, returns None (rank 0 has written the
    outputs)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        card = int(os.environ.get("LOCAL_RANK", 0)) if cuda else None
        return _run(main, argv, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                    "env://", card)
    if not cuda:
        return _run(main, argv, 0, 1, None, None)
    world = torch.cuda.device_count()
    if world == 0:
        raise RuntimeError("no CUDA device is available; pass --no-cuda to run on "
                           "the CPU")
    torch.multiprocessing.spawn(
        _worker, args=(main, argv, world, f"tcp://localhost:{_free_port()}"),
        nprocs=world, join=True)
    return None
