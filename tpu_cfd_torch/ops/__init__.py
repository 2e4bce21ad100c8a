"""Discrete operators: spectral calculus, dense DFTs, finite differences,
fast diagonalization, interpolation, and CUDA kernels."""
