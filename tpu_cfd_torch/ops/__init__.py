"""Discrete operators: spectral calculus, dense DFTs, and CUDA kernels."""
