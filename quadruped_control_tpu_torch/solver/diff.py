"""Differentiable QP solve: implicit-function-theorem gradients as a
``torch.autograd.Function`` (counterpart of
``quadruped_control_tpu/solver/diff.py``, a ``jax.custom_vjp`` there).

Differentiating through the unrolled barrier loop works (solver/ipm.py is
plain PyTorch) but costs ~iterations x the forward pass in memory and time
and cannot see through the certified polish's selects. This module
differentiates the solution map (Q, c, G, h) -> x*(Q, c, G, h) of

    min 1/2 x^T Q x + c^T x   s.t.  G x <= h

through the KKT conditions at the solved point (OptNet, Amos & Kolter
2017):

    Q x + c + G^T z = 0,     diag(z) (G x - h) = 0.

Backward: with (dtx, dtz) = K^{-T} (dL/dx, 0), K the KKT Jacobian,

    dL/dc = -dtx
    dL/dQ = -sym(dtx x^T)
    dL/dG = -(z dtx^T + diag(z) dtz x^T)
    dL/dh = z * dtz

The K^{-T} solve uses the FULL (n+m) KKT Jacobian, not the z/s-condensed
normal form: the GRF family mixes ~1e-5-curvature swing directions with
active rows, and the condensed form's z/(s+delta) ~ 1e10 weights poison any
regularization of the soft directions (the JAX package measured a 19x
gradient error). The full K keeps every entry at problem scale, so an LU
with one refinement pass is exact under strict complementarity.
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm


def _sum_to(g, shape):
    """Sum a broadcast gradient back to an input's shape."""
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _ImplicitQP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Q, c, G, h, iterations, polish, delta):
        sol = solve_qp_ipm(Q, c, G, h, iterations=iterations, polish=polish)
        ctx.save_for_backward(Q, c, G, h, sol.x, sol.z, sol.s)
        ctx.delta = delta
        return sol.x

    @staticmethod
    def backward(ctx, gx):
        Q, c, G, h, x, z, s = ctx.saved_tensors
        dtype, device = Q.dtype, Q.device
        n = Q.shape[-1]
        m = G.shape[-2]
        batch = tuple(torch.broadcast_shapes(Q.shape[:-2], G.shape[:-2],
                                             z.shape[:-1]))

        # K^T = [[Q, G^T diag(z)], [G, -diag(s + delta)]]; delta
        # regularizes weakly-active rows (z ~ s ~ 0), where the implicit
        # derivative is genuinely set-valued.
        GTz = G.transpose(-1, -2) * z[..., None, :]
        top = torch.cat([Q.expand(batch + (n, n)), GTz.expand(
            batch + (n, m))], dim=-1)
        d_reg = ctx.delta * (1.0 + torch.abs(h))
        diag_s = -(s + d_reg)
        eye_m = torch.eye(m, dtype=dtype, device=device)
        bottom = torch.cat([G.expand(batch + (m, n)),
                            (diag_s[..., None, :] * eye_m).expand(
                                batch + (m, m))], dim=-1)
        KT = torch.cat([top, bottom], dim=-2)
        rhs = torch.cat([gx.expand(batch + (n,)),
                         torch.zeros(batch + (m,), dtype=dtype,
                                     device=device)], dim=-1)

        LU, piv = torch.linalg.lu_factor(KT)
        sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
        # One refinement pass.
        resid = rhs - torch.einsum("...ij,...j->...i", KT, sol)
        sol = sol + torch.linalg.lu_solve(LU, piv, resid[..., None])[..., 0]

        dtx, dtlam = sol[..., :n], sol[..., n:]
        z_dtlam = z * dtlam
        dQ = -0.5 * (dtx[..., :, None] * x[..., None, :]
                     + x[..., :, None] * dtx[..., None, :])
        dc = -dtx
        dG = -(z[..., :, None] * dtx[..., None, :]
               + z_dtlam[..., :, None] * x[..., None, :])
        dh = z_dtlam
        return (_sum_to(dQ, Q.shape), _sum_to(dc, c.shape),
                _sum_to(dG, G.shape), _sum_to(dh, h.shape), None, None, None)


def solve_qp_implicit(Q, c, G, h, iterations: int = 30, polish: bool = True,
                      delta: float = 1e-8):
    """QP solve returning only x*, with implicit gradients with respect to
    (Q, c, G, h); ``iterations``, ``polish`` and ``delta`` are not
    differentiable.

    The forward pass is the full certified solver (``solve_qp_ipm``, polish
    as given). The gradient does not differentiate through it: it
    differentiates the optimality conditions at the returned point, so a
    more accurate forward point gives a more accurate gradient.
    """
    return _ImplicitQP.apply(Q, c, G, h, iterations, polish, delta)
