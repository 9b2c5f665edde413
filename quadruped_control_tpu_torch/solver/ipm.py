"""Batched primal-dual interior-point QP solver (Mehrotra predictor-corrector).

This is the batched replacement for the reference's warm-started qpOASES
active-set solve (balance_controller.cpp:177-208): instead of amortizing one
QP across ticks via hotstart, we amortize across *instances* — thousands of
independent 12-var friction-cone QPs solved simultaneously. The entire solve
is a fixed-iteration loop of dense (..., 12, 12) linear algebra on whole
batches. It is the plain, general-shape solver of the port and the yardstick
the fused CUDA path (solver/fused.py) is tested against.

Problem form (see ops/dynamics.py):

    min_x 1/2 x^T Q x + c^T x   s.t.   G x <= h

with Q symmetric positive definite (the reference's W-regularization,
balance_controller.cpp:152, guarantees this). The Newton/KKT system is
condensed to the 12x12 normal form M = Q + G^T diag(z/s) G, factored by
Cholesky once per iteration and reused for the corrector solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IPMSolution(NamedTuple):
    x: torch.Tensor  # (..., n) primal solution
    z: torch.Tensor  # (..., m) dual (inequality multipliers)
    s: torch.Tensor  # (..., m) slacks
    iterations: torch.Tensor  # () iterations run (static count)
    gap: torch.Tensor  # (...,) final complementarity mu
    primal_residual: torch.Tensor  # (...,) inf-norm of G x + s - h
    dual_residual: torch.Tensor  # (...,) inf-norm of Q x + c + G^T z
    converged: torch.Tensor  # (...,) bool


def _cholesky_solve(L, b):
    """Solve A x = b given lower Cholesky factor L (batched)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _cholesky_nan(A):
    """Lower Cholesky factor; a non-PD matrix gives a NaN factor (data, not
    an exception), so the finite-step guard of the barrier loop rejects the
    step for that instance alone."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None], float("nan"), L)


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, y):
    return torch.einsum("...ji,...j->...i", A, y)


def _amax(a):
    return torch.amax(a, dim=-1)


def _max_step(v, dv, tau):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v  (fraction-to-
    the-boundary), batched over trailing constraint dim."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        float("inf"))
    alpha = tau * torch.amin(ratio, dim=-1)
    return torch.clamp(alpha, max=1.0)


_POLISH_SWEEPS = 12


def _polish(Q, c, G, h, x_ipm, z_ipm, s_ipm):
    """Active-set polish (OSQP-style): once the IPM has identified the active
    set, solve the equality-constrained KKT exactly and keep the polished
    point when it certifies. This recovers machine-precision parity with an
    active-set solver (qpOASES) even in the GRF family's 1e-5-curvature flat
    directions, where the barrier-condensed system is limited to ~1e-5
    accuracy by conditioning.

    Static shapes: inactive constraints are represented by identity rows
    forcing z_i = 0, so every instance solves the same (n+m) dense system.
    """
    from quadruped_control_tpu_torch.utils.ff import (
        residual_compensated,
        solve_refined,
    )

    dtype = Q.dtype
    n = Q.shape[-1]
    m = G.shape[-2]
    eps = torch.finfo(dtype).eps
    eye_m = torch.eye(m, dtype=dtype, device=Q.device)
    top = torch.cat([Q, G.transpose(-1, -2)], dim=-1)
    h_scale = 1.0 + _amax(torch.abs(h))
    obj_scale = 1.0 + _amax(torch.abs(c))
    # With the refined solve + compensated certification the stationarity
    # check can sit a hair above machine epsilon — in float32 this is what
    # makes polish acceptance (and hence qpOASES-level parity) possible at
    # all on float32 hardware.
    cert_dr = max(1e-9, 30.0 * eps) * obj_scale
    feas_tol = max(1e-6, 30.0 * eps) * h_scale
    z_tol = max(1e-6, 30.0 * eps) * (1.0 + _amax(z_ipm))

    def try_active(active):
        # K = [[Q, G^T], [diag(a) G, diag(1-a)]],  rhs = [-c, a*h].
        aG = active[..., None] * G
        lower = torch.cat(
            [aG, (1.0 - active)[..., None] * eye_m], dim=-1
        )
        K = torch.cat([top, lower], dim=-2)
        rhs = torch.cat([-c, active * h], dim=-1)
        # LU + compensated iterative refinement: ~eps-relative
        # solution even at kappa ~ 1e7 (utils/ff.py).
        sol = solve_refined(K, rhs)
        x_p, z_p = sol[..., :n], sol[..., n:]

        # Certify with a compensated KKT residual (a plain f32 evaluation
        # would bury the true residual under evaluation roundoff).
        r_full = residual_compensated(K, sol, rhs)
        r_dual_p = r_full[..., :n]
        slack_p = h - _mv(G, x_p)
        ok = (
            torch.all(torch.isfinite(x_p), dim=-1)
            & torch.all(torch.isfinite(z_p), dim=-1)
            & (torch.amin(slack_p, dim=-1) > -feas_tol)
            & (torch.amin(z_p, dim=-1) > -z_tol)
            & (_amax(torch.abs(r_dual_p)) < cert_dr)
        )
        return ok, x_p, z_p, slack_p

    # Active-set refinement: start from the barrier iterate's guess and run
    # qpOASES-style single-swap iterations — add the most violated row, else
    # drop the most negative multiplier. Float32 barrier iterates sometimes
    # misidentify the set (especially near degeneracy); a handful of swaps
    # with certified EQP solves repairs it. All instances run the same fixed
    # number of swaps; certified instances freeze.
    a = (z_ipm > s_ipm).to(dtype)
    big = float(torch.finfo(dtype).max / 4)
    certified = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    best_x, best_z, best_s = x_ipm, z_ipm, s_ipm
    rows = torch.arange(m, device=a.device)

    for _ in range(_POLISH_SWEEPS):
        ok, x_p, z_p, slack_p = try_active(a)
        take = (ok & ~certified)[..., None]
        best_x = torch.where(take, x_p, best_x)
        best_z = torch.where(take, torch.clamp(z_p, min=0.0), best_z)
        best_s = torch.where(take, torch.clamp(slack_p, min=0.0), best_s)
        certified = certified | ok

        # Most violated inactive row (add) / most negative multiplier (drop).
        viol = torch.where(a > 0.5, -big, -slack_p)  # (..., m)
        viol_max, add_idx = _max_first(viol)
        negz = torch.where(a > 0.5, z_p, big)
        neg_min, drop_idx = _max_first(-negz)
        neg_min = -neg_min

        do_add = viol_max > feas_tol
        do_drop = (~do_add) & (neg_min < -z_tol)
        onehot_add = (rows == add_idx[..., None]).to(dtype)
        onehot_drop = (rows == drop_idx[..., None]).to(dtype)
        a_new = torch.where(do_add[..., None], torch.maximum(a, onehot_add),
                            torch.where(do_drop[..., None],
                                        a * (1.0 - onehot_drop), a))
        a = torch.where(certified[..., None], a, a_new)

    return best_x, best_z, best_s, certified


def _max_first(v):
    """(max, index of its FIRST occurrence) along the last dim, NaN counting
    as the maximum — the tie and NaN rules of ``jnp.max``/``jnp.argmax``,
    which the single-swap rule inherits (``torch.max`` leaves the index of a
    tie unspecified)."""
    key = torch.where(torch.isnan(v), float("inf"), v)
    vmax = torch.amax(key, dim=-1, keepdim=True)
    m = v.shape[-1]
    pos = torch.arange(m, device=v.device).expand(v.shape)
    idx = torch.amin(torch.where(key == vmax, pos, m), dim=-1)
    val = torch.take_along_dim(v, idx[..., None], dim=-1)[..., 0]
    return val, idx


def equilibrate(Q, c, G, h):
    """Diagonal problem scaling (OSQP-style, one-shot).

    Float32 cannot run the barrier path on the raw GRF problem
    (h spans [0, 1e4], |c| ~ 1e4, kappa(Q) ~ 1e6): variables are scaled by
    1/sqrt(diag(Q)) (Jacobi), constraint rows of the scaled G to unit
    inf-norm, and the cost to unit magnitude. Returns the scaled problem and
    the scaling factors needed to map the solution back:

      x = Dv * x_s,  z = (Er / nu) * z_s,  s = s_s / Er.
    """
    diag_q = torch.diagonal(Q, dim1=-2, dim2=-1)
    Dv = 1.0 / torch.sqrt(torch.clamp(diag_q, min=1e-12))  # (..., n)
    Qs = Q * Dv[..., :, None] * Dv[..., None, :]
    cs = c * Dv
    Gs = G * Dv[..., None, :]
    row_norm = torch.clamp(_amax(torch.abs(Gs)), min=1e-12)  # (..., m)
    Er = 1.0 / row_norm
    Gs = Gs * Er[..., None]
    hs = h * Er
    nu = 1.0 / torch.clamp(_amax(torch.abs(cs)), min=1e-12)  # (...,)
    Qs = Qs * nu[..., None, None]
    cs = cs * nu[..., None]
    return Qs, cs, Gs, hs, Dv, Er, nu


def solve_qp_ipm(Q, c, G, h, iterations: int = 25, tol: float = 1e-7,
                 tau: float = 0.995, static_reg: float = 0.0,
                 polish: bool = True, scale: bool = True,
                 d_max: float | None = None, reg_factor: float = 100.0,
                 unrolled_linalg: bool = False,
                 warm_start=None, warm_reset_mask=None) -> IPMSolution:
    """Solve a batch of inequality-constrained QPs.

    Args:
      Q: (..., n, n) SPD Hessians.
      c: (..., n).
      G: (..., m, n) inequality rows.
      h: (..., m) bounds (G x <= h).
      iterations: fixed Newton iteration count (every instance in the
        batch runs the same schedule — the batch-friendly replacement for
        per-instance early exit).
      tol: convergence tolerance used only for the reported ``converged``
        mask (relative on residuals and gap).
      tau: fraction-to-the-boundary parameter.
      static_reg: optional diagonal regularization added to the condensed
        KKT matrix (0 disables).
      polish: run the active-set polish after the barrier loop.
      scale: equilibrate the problem first (required for float32).
      warm_start: optional (x, s, z) in ORIGINAL units — typically the
        previous tick's IPMSolution fields. Replaces the reference's
        qpOASES hotstart economics (balance_controller.cpp:193-195) for
        control/MPC streams: slacks and duals are pushed back to the
        interior (Mehrotra shift) so a nearby previous solution converges
        in a fraction of the cold-start schedule.
      warm_reset_mask: optional (..., m) bool — rows whose warm slack/dual
        are STALE and must cold-start (transition-aware reset). The gait
        use: when a leg flips stance<->swing its 6 cone rows jump between
        h = 0-bounds and the relaxed swing bound, so the carried (s, z) sit
        on the wrong side of the new boundary and stall the barrier; pass
        repeat(stance_changed, 6) to re-center exactly those rows.

    Returns:
      IPMSolution with leading batch dims preserved; diagnostics are
      reported in the ORIGINAL (unscaled) problem's units.
    """
    if scale:
        Q0, c0, G0, h0 = Q, c, G, h
        Q, c, G, h, Dv, Er, nu = equilibrate(Q, c, G, h)
    dtype = Q.dtype
    m = G.shape[-2]
    n = Q.shape[-1]
    eye_n = torch.eye(n, dtype=dtype, device=Q.device)

    # --- Initialization -----------------------------------------------------
    # Cold start: x0 = 0 (scale-free; the unconstrained minimizer -Q^-1 c is
    # catastrophic for the GRF family, whose W-regularized Hessian has ~1e-5
    # eigenvalues); s0: clamped slack at x0; z0 = mu0 / s0 so every
    # complementarity product starts at mu0 — this keeps the huge relaxed
    # swing-row slacks (h ~ 1e4) from inflating mu.
    if warm_start is None:
        x0 = torch.zeros_like(c)
        s0 = torch.clamp(h, min=1.0)
        z0 = 1.0 / s0
    else:
        xw, sw, zw = warm_start
        if scale:
            # Map original-unit warm values into equilibrated coordinates.
            xw = xw / Dv
            sw = sw * Er
            zw = zw * nu[..., None] / Er
        # Push back to the interior: a boundary start (s or z ~ 0) stalls
        # the barrier; the shift re-centers at a modest mu.
        interior = 1e-2
        x0 = xw
        s0 = torch.clamp(sw, min=interior)
        z0 = torch.clamp(zw, min=interior)
        if warm_reset_mask is not None:
            s_cold = torch.clamp(h, min=1.0)
            s0 = torch.where(warm_reset_mask, s_cold, s0)
            z0 = torch.where(warm_reset_mask, 1.0 / s_cold, z0)

    # Freeze thresholds: once an instance reaches machine-precision optimality
    # further Newton steps only amplify roundoff (d = z/s overflows and the
    # Cholesky goes NaN), so converged instances stop moving. All instances
    # still run the same fixed schedule — the mask is data, not control flow.
    eps = torch.finfo(dtype).eps
    obj_scale = 1.0 + _amax(torch.abs(c))
    h_scale = 1.0 + _amax(torch.abs(h))
    # Freeze ~3 decades below the user tolerance (or at the roundoff floor,
    # whichever is higher) — tight enough for 1e-6-level objective parity,
    # early enough that the condensed system is still well-posed.
    freeze_gap = max(1e-4 * tol, 100.0 * eps) * obj_scale
    freeze_pr = max(tol, 50.0 * eps) * h_scale
    freeze_dr = max(tol, 50.0 * eps) * obj_scale
    if d_max is None:
        d_max = 1.0 / eps

    def body(carry):
        x, s, z, best = carry
        Gx = _mv(G, x)
        r_dual = _mv(Q, x) + c + _mtv(G, z)
        r_prim = Gx + s - h

        # Best-iterate tracking: float32 late-stage steps can regress or blow
        # up; the returned iterate is the best by scaled KKT merit, making
        # extra iterations always safe.
        merit = (
            _amax(torch.abs(r_prim)) / h_scale
            + _amax(torch.abs(r_dual)) / obj_scale
            + torch.abs(torch.sum(s * z, dim=-1)) / (m * obj_scale)
        )
        bx, bs, bz, bmerit = best
        improve = (merit < bmerit) & torch.all(torch.isfinite(x), dim=-1)
        imp = improve[..., None]
        best = (
            torch.where(imp, x, bx),
            torch.where(imp, s, bs),
            torch.where(imp, z, bz),
            torch.where(improve, merit, bmerit),
        )

        d = torch.clamp(z / s, max=d_max)  # (..., m)
        M = Q + torch.einsum("...ki,...k,...kj->...ij", G, d, G)
        if static_reg:
            M = M + static_reg * eye_n
        # Late-stage barrier terms reach d ~ 1/eps, and rounding then makes M
        # numerically indefinite relative to Q's smallest eigenvalues
        # (~1e-5 for the W-regularized GRF Hessian). Factor a regularized
        # copy and recover accuracy with one refinement pass against the
        # true M — the standard condensed-KKT recipe.
        diag_M = torch.diagonal(M, dim1=-2, dim2=-1)
        delta = (reg_factor * eps) * _amax(diag_M)
        M_reg = M + delta[..., None, None] * eye_n

        if unrolled_linalg:
            # Fully-unrolled batched Cholesky: elementwise on (B,) tensors,
            # the operation order of the CUDA kernels.
            from quadruped_control_tpu_torch.solver.smallalg import (
                cholesky_solve_unrolled,
                cholesky_unrolled,
            )

            Lu = cholesky_unrolled(M_reg, n)

            def kkt_solve(rhs):
                dx = cholesky_solve_unrolled(Lu, rhs, n)
                resid = rhs - _mv(M, dx)
                return dx + cholesky_solve_unrolled(Lu, resid, n)
        else:
            L = _cholesky_nan(M_reg)

            def kkt_solve(rhs):
                dx = _cholesky_solve(L, rhs)
                resid = rhs - _mv(M, dx)
                return dx + _cholesky_solve(L, resid)

        mu = torch.sum(s * z, dim=-1) / m

        # ---- affine (predictor) step ----
        r_cent_aff = s * z
        rhs_aff = -(r_dual + _mtv(G, (z * r_prim - r_cent_aff) / s))
        dx_aff = kkt_solve(rhs_aff)
        ds_aff = -r_prim - _mv(G, dx_aff)
        dz_aff = -(r_cent_aff + z * ds_aff) / s

        alpha_s = _max_step(s, ds_aff, 1.0)
        alpha_z = _max_step(z, dz_aff, 1.0)
        alpha_aff = torch.minimum(alpha_s, alpha_z)

        mu_aff = torch.sum(
            (s + alpha_aff[..., None] * ds_aff) * (z + alpha_aff[..., None] * dz_aff),
            dim=-1,
        ) / m
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # ---- corrector step (reuses the factorization) ----
        r_cent = s * z + ds_aff * dz_aff - (sigma * mu)[..., None]
        rhs = -(r_dual + _mtv(G, (z * r_prim - r_cent) / s))
        dx = kkt_solve(rhs)
        ds = -r_prim - _mv(G, dx)
        dz = -(r_cent + z * ds) / s

        alpha = torch.minimum(_max_step(s, ds, tau), _max_step(z, dz, tau))

        done = (
            (mu < freeze_gap)
            & (_amax(torch.abs(r_prim)) < freeze_pr)
            & (_amax(torch.abs(r_dual)) < freeze_dr)
        )
        # Guard: a step that overflowed (inf/nan anywhere) is skipped rather
        # than letting one bad instance poison its lane.
        step_ok = (
            torch.all(torch.isfinite(dx), dim=-1)
            & torch.all(torch.isfinite(ds), dim=-1)
            & torch.all(torch.isfinite(dz), dim=-1)
        )
        a = torch.where(done | ~step_ok, 0.0, alpha)[..., None]
        tiny = torch.finfo(dtype).tiny
        # torch.clamp keeps a NaN (0 * NaN poison of a skipped step), as
        # jnp.maximum does: the instance stays frozen at its best iterate.
        return (
            x + a * dx,
            torch.clamp(s + a * ds, min=tiny),
            torch.clamp(z + a * dz, min=tiny),
            best,
        )

    batch = tuple(torch.broadcast_shapes(Q.shape[:-2], c.shape[:-1],
                                         h.shape[:-1]))
    best0 = (
        x0.expand(batch + (n,)),
        s0.expand(batch + (m,)),
        z0.expand(batch + (m,)),
        torch.full(batch, float("inf"), dtype=dtype, device=Q.device),
    )
    carry = (x0, s0, z0, best0)
    for _ in range(iterations):
        carry = body(carry)
    x, s, z, best = carry
    # One more merit evaluation for the final iterate.
    r_dual_f = _mv(Q, x) + c + _mtv(G, z)
    r_prim_f = _mv(G, x) + s - h
    merit_f = (
        _amax(torch.abs(r_prim_f)) / h_scale
        + _amax(torch.abs(r_dual_f)) / obj_scale
        + torch.abs(torch.sum(s * z, dim=-1)) / (m * obj_scale)
    )
    bx, bs, bz, bmerit = best
    keep_final = (merit_f < bmerit) & torch.all(torch.isfinite(x), dim=-1)
    kf = keep_final[..., None]
    x = torch.where(kf, x, bx)
    s = torch.where(kf, s, bs)
    z = torch.where(kf, z, bz)

    certified = None
    if polish:
        x, z, s, certified = _polish(Q, c, G, h, x, z, s)

    if scale:
        # Map back to the original problem's units.
        x = x * Dv
        z = z * Er / nu[..., None]
        s = s / Er
        Q, c, G, h = Q0, c0, G0, h0

    # --- Final diagnostics --------------------------------------------------
    r_dual = _mv(Q, x) + c + _mtv(G, z)
    r_prim = _mv(G, x) + s - h
    gap = torch.sum(s * z, dim=-1) / m
    scale = 1.0 + _amax(torch.abs(c))
    pr = _amax(torch.abs(r_prim))
    dr = _amax(torch.abs(r_dual))
    converged = (pr < tol * (1.0 + _amax(torch.abs(h)))) & \
                (dr < tol * scale) & (gap < tol * scale)
    if certified is not None:
        # A polish certificate (KKT-verified at ~30 eps on the equilibrated
        # problem) is a stronger statement than the tol-based check.
        converged = converged | certified

    return IPMSolution(
        x=x, z=z, s=s,
        iterations=torch.as_tensor(iterations),
        gap=gap, primal_residual=pr, dual_residual=dr, converged=converged,
    )


def qp_objective(Q, c, x):
    """1/2 x^T Q x + c^T x (batched)."""
    Qx = _mv(Q, x)
    return 0.5 * torch.sum(x * Qx, dim=-1) + torch.sum(c * x, dim=-1)


def solve_qp_prox(Q, c, G, h, x0=None, rho_rel: float = 1e-2,
                  prox_steps: int = 4, iterations: int = 30,
                  tol: float = 3e-5, polish: bool = True,
                  unrolled_linalg: bool = True) -> IPMSolution:
    """Proximal-point restart for ill-conditioned QPs.

    Solves x_{k+1} = argmin 1/2 x^T (Q + rho I) x + (c - rho x_k)^T x
    s.t. Gx <= h for ``prox_steps`` rounds (ProxQP-style). Each subproblem's
    conditioning improves by ~rho/lambda_min(Q), so float32 solves it
    cleanly, and the ORIGINAL problem's dual residual at round k is exactly
    rho (x_{k-1} - x_k) — it contracts as the prox iterates converge.

    Built for the GRF family's certification tail: the degenerate 4-stance
    instances (rank-6 A^T S A + 1e-5 W, condition ~1e6) sit at f32's
    stationarity floor for direct solves; measured on the harvested hard
    set of the reference package (its scripts/tail_prox.py, f32), prox
    rho_rel=1e-2 x4 certifies ~80% of them vs ~30% for a direct
    60-iteration solve, objective error p50 ~2e-8.

    Args:
      x0: optional (..., n) warm point (e.g. the failed solve's iterate).
      rho_rel: rho = rho_rel * mean(diag(Q)) per instance.
      tol: certification tolerance, applied to the ORIGINAL KKT.
    Returns:
      IPMSolution whose ``converged`` certifies against the ORIGINAL
      (Q, c) — not the proximal subproblem.
    """
    n = Q.shape[-1]
    m = G.shape[-2]
    diag = torch.diagonal(Q, dim1=-2, dim2=-1)
    rho = rho_rel * diag.mean(-1)[..., None]
    Qp = Q + rho[..., None] * torch.eye(n, dtype=Q.dtype, device=Q.device)
    xk = torch.zeros_like(c) if x0 is None else x0

    sol = None
    for _ in range(prox_steps):
        sol = solve_qp_ipm(Qp, c - rho * xk, G, h, iterations=iterations,
                           polish=polish, tol=tol,
                           unrolled_linalg=unrolled_linalg)
        xk = sol.x

    # Certify against the ORIGINAL problem (solve_qp_ipm's criterion).
    pr = _amax(torch.abs(_mv(G, xk) + sol.s - h))
    dr = _amax(torch.abs(_mv(Q, xk) + c + _mtv(G, sol.z)))
    gap = torch.abs(torch.sum(sol.s * sol.z, dim=-1)) / m
    scale = 1.0 + _amax(torch.abs(c))
    hmax = 1.0 + _amax(torch.abs(h))
    converged = (pr < tol * hmax) & (dr < tol * scale) & (gap < tol * scale)
    return IPMSolution(x=xk, z=sol.z, s=sol.s,
                       iterations=torch.as_tensor(prox_steps * iterations),
                       gap=gap, primal_residual=pr, dual_residual=dr,
                       converged=converged)
