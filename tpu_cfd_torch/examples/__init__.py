"""Runnable examples of the port: ``python -m tpu_cfd_torch.examples.<name>``."""
