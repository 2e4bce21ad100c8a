"""Plain references the benchmark holds the port to.

Plain PyTorch and NumPy only: nothing here imports the port, ``jax`` or the
JAX package. Each works out again, from the inputs the benchmark made (noise,
data, weights, epoch indices), what the port derives from them.
"""
