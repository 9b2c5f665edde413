"""Unrolled small-matrix linear algebra for batched tiny problems.

The factorizations are fully unrolled over the (static, tiny) matrix
dimension into elementwise ops on (B,) tensors — one problem instance per
batch element, the layout the CUDA kernels use (one instance per thread).
The unrolled PyTorch version is their portable twin and correctness oracle:
the operation order, and so the rounding and the NaN poison of a non-PD
pivot, follow the kernel.

All functions take (..., n, n) / (..., n) tensors with any batch shape.
"""

from __future__ import annotations

import torch


def rsqrt_exact(d):
    """1/sqrt(d) from the two correctly-rounded IEEE operations, so that the
    CPU, the card's elementwise ops and the CUDA kernels (``1.0f /
    sqrtf(x)``) agree to the bit (``torch.rsqrt`` on the card is the 2-ulp
    approximate instruction)."""
    return 1.0 / torch.sqrt(d)


def cholesky_unrolled(A, n: int):
    """Lower Cholesky of (..., n, n) SPD matrices, fully unrolled.

    Returns columns as a list-of-lists L[i][j] (i >= j) of (...,) tensors;
    use :func:`cholesky_solve_unrolled` to consume it.
    """
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    nan = float("nan")
    for j in range(n):
        d = a[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        # Non-PD pivot -> NaN, matching torch.linalg.cholesky's failure
        # semantics in data: the solver's finite-step guard then rejects the
        # step instead of accepting a huge-but-finite garbage direction.
        d = torch.where(d > 0.0, d, nan)
        inv = rsqrt_exact(d)
        L[j][j] = d * inv  # sqrt(d)
        for i in range(j + 1, n):
            v = a[i][j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v * inv
    return L


def cholesky_solve_unrolled(L, b, n: int):
    """Solve (L L^T) x = b given unrolled ``L``; b is (..., n)."""
    y = [None] * n
    for i in range(n):
        v = b[..., i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y[i] = v / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for k in range(i + 1, n):
            v = v - L[k][i] * x[k]
        x[i] = v / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_factor_solve(A, b, n: int):
    """One-shot solve A x = b for (..., n, n) SPD A."""
    return cholesky_solve_unrolled(cholesky_unrolled(A, n), b, n)
