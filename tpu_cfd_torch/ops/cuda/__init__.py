"""Hand-written CUDA kernels for Hopper, bound with ctypes."""


def on_card(t, kernels: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (its
    plain version runs); raises for any other device, naming ``kernels``."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernels} kernel for device {t.device}")
    return t.device.type == "cuda"
