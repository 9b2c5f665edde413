"""Compensated ("float-float") arithmetic helpers for float32 hardware.

The GRF QP family needs ~1e-6-relative linear solves on systems with
condition numbers near 1/eps_f32 — unreachable by plain float32. The classic
mixed-precision remedy (Wilkinson iterative refinement) only works if the
RESIDUAL r = b - A x is computed to better than working precision; these
helpers provide that via error-free transformations (Dekker splitting +
compensated summation), turning each float32 product/sum into a
(value, error) pair without any float64.

Used by the solver polish path (solver/ipm.py). PyTorch's eager elementwise
ops round every product and sum separately (no FMA contraction), which is
what the error-free transformations need; the CUDA kernels get the same
guarantee from explicit ``__fmul_rn``/``__fadd_rn`` and ``-fmad=false``.
"""

from __future__ import annotations

import torch

# Dekker split constant for float32: 2^12 + 1 (24-bit mantissa -> 12+12).
_SPLIT_F32 = 4097.0
# For float64: 2^27 + 1.
_SPLIT_F64 = 134217729.0


def _split_const(dtype):
    return _SPLIT_F32 if dtype == torch.float32 else _SPLIT_F64


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth TwoSum, 6 flops)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo having half-width mantissas."""
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, FMA-free)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """Double-float addition: (a_hi + a_lo) + (b_hi + b_lo) -> (hi, lo)."""
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    hi, lo = two_sum(s, e)
    return hi, lo


def compensated_sum(terms, axis: int = -1):
    """Compensated summation along ``axis`` via a pairwise double-float
    reduction tree (log-depth, fully vectorized).

    Returns the sum accurate to ~eps * |sum| + n * eps^2 * sum|terms| —
    i.e. cancellation between large terms is captured instead of lost.
    """
    hi = torch.movedim(terms, axis, 0)
    lo = torch.zeros_like(hi)
    while hi.shape[0] > 1:
        if hi.shape[0] % 2 == 1:
            hi = torch.cat([hi, torch.zeros_like(hi[:1])], dim=0)
            lo = torch.cat([lo, torch.zeros_like(lo[:1])], dim=0)
        hi, lo = _df_add(hi[0::2], lo[0::2], hi[1::2], lo[1::2])
    return hi[0] + lo[0]


def residual_compensated(A, x, b):
    """r = b - A @ x with compensated products and summation.

    The returned residual is accurate to ~eps * |r| even when
    |r| << |A||x| (deep cancellation) — exactly what iterative refinement
    needs to make a float32 factorization deliver ~1e-7-relative solutions.

    Args:
      A: (..., n, n); x: (..., n); b: (..., n).
    Returns:
      (..., n).
    """
    p, e = two_prod(A, x[..., None, :])  # (..., n, n) each
    terms = torch.cat([-b[..., None], p], dim=-1)
    main = compensated_sum(terms, axis=-1)
    return -(main + torch.sum(e, dim=-1))


def solve_refined(A, b, n_refine: int = 4):
    """Solve A x = b via an LU factorization in the working precision +
    compensated iterative refinement.

    Forward error contracts by ~(eps * kappa) per sweep; with the
    compensated residual the limiting accuracy is ~eps relative — for
    kappa ~ 1e5-1e6 in float32, 3-4 sweeps reach it. In float64 this is
    simply a very accurate dense solve.

    Args:
      A: (..., n, n); b: (..., n).
    Returns:
      (..., n).
    """
    # The _ex form does not raise on a singular matrix: such an instance
    # solves to inf/NaN (data, as in the JAX package) and the caller's
    # finite-value certificate rejects it.
    LU, pivots, _ = torch.linalg.lu_factor_ex(A)

    def lu_solve(rhs):
        return torch.linalg.lu_solve(LU, pivots, rhs[..., None])[..., 0]

    x = lu_solve(b)
    for _ in range(n_refine):
        r = residual_compensated(A, x, b)
        x = x + lu_solve(r)
    return x
