"""Operations and bytes of each configuration's work, by configuration name.

A count is what the inputs need, whatever implements it: each real transform
of N points counts as a radix-2 FFT, 2.5 N log2 N operations; a product of
(m x k) by (k x n) counts 2 m k n (8 m k n for complex); bytes count each
input read once and each output written once.
"""

import math


def fft_flops(points: int) -> float:
    """A real transform of ``points`` points, counted as a radix-2 FFT."""
    return 2.5 * points * math.log2(points)
