"""Device selection for the port's entry points.

Entry points run on the card by default. They run on the CPU only when the
caller asks for it (``device="cpu"``, or ``--no-cuda`` on the command line);
without a card and without that request they raise instead of carrying on.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the default CUDA device; any CUDA device must exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --no-cuda on "
            "the command line) to run on the CPU"
        )
    return device
