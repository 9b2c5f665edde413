"""Dense batched QP solve in two CUDA kernels: a fixed-iteration Mehrotra
barrier (K3a) and a certified active-set polish (K3b).

Port of ``quadruped_control_tpu/solver/pallas_ipm.py``. The general dense
entry for any equilibrated 12-variable, 24-row QP

    min_x 1/2 x^T Q x + c^T x   s.t.   G x <= h

(the GRF QP of ``ops/dynamics.py`` is one), the drop-in for
``solver/ipm.solve_qp_ipm``: equilibration (``solver/ipm.equilibrate``),
the map back to original units and the reported diagnostics are plain
PyTorch, as in the JAX package, where they run outside any kernel; only the
barrier loop and the polish run in the kernels.

Two kernels live here, each with a wrapper and a PLAIN PYTORCH VERSION
beside it (csrc/qct_dense_ipm.cu and .cuh hold the CUDA C++):

  - K3a (``dense_barrier`` -> ``qct_dense_barrier``, plain
    ``_dense_barrier_plain``): the Mehrotra predictor-corrector on the dense
    equilibrated problem. ``M = Q + G^T D G`` (upper triangle), diagonal
    regularisation ``100 eps max diag``, 12x12 Cholesky storing ``1/L_jj``,
    one refinement pass against the un-regularised ``M``, freeze test, best
    iterate by scaled KKT merit, finite-step guard.
  - K3b (``dense_polish`` -> ``qct_dense_polish``, plain
    ``_dense_polish_plain``): the active-set polish from K3a's ``(x, s,
    z)``. Per sweep the quasidefinite EQP KKT ``[[Q, (aG)^T], [aG, -R]]``,
    an in-place 36x36 LDL^T without pivoting, four refinements against the
    reg-free system, a Dekker-compensated stationarity residual, the strict
    certificate latched on the first certified sweep, and the
    add-most-violated / drop-most-negative swap frozen once certified.

The plain versions follow the kernels statement for statement: every sum
is accumulated in the kernel's order (vectorised only across the index the
kernel does not reduce over), every max / min propagates NaN, division is
tensor by tensor where the kernel divides once. A wrapper takes the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises.

Layout: structure of arrays ``(k, B)`` (K3a and K3b each run one instance
per group of 16 lanes after the block has staged the problems in shared
memory), component-major so that the staging loads coalesce: ``Q (144, B)``
(row-major ``i * 12 + j``), ``c (12, B)``, ``G (288, B)`` (``r * 12 + j``),
``h (24, B)``, float32; any B (the kernels mask the ragged edge). The TPU
kernels' ``(nb, k, 8, 128)`` tile layout has no counterpart
(``convert.tiles_to_comps`` / ``comps_to_tiles`` exchange it in tests).
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch import kernels, resolve_device
from quadruped_control_tpu_torch.solver.fused import (
    _BIG,
    _EPS,
    _NAN,
    _POLISH_REFINE,
    _POLISH_SWEEPS_FUSED as _POLISH_SWEEPS_PALLAS,
    _TINY,
    _check_soa,
    _f32,
    _ff_linear,
    _fmax,
    _fmin,
    _rsqrt,
    _soa,
)
from quadruped_control_tpu_torch.solver.ipm import (
    IPMSolution,
    _amax,
    _mtv,
    _mv,
    equilibrate,
)

N = 12
M = 24
NK = N + M  # full KKT dimension (36)


def _scales(c, h):
    """obj_scale, h_scale of the JAX kernels: the max starts from
    ``c[0] * 0 + 1`` (NaN on a lane whose first entry is not finite)."""
    obj_scale = _fmax(c[0] * 0.0 + 1.0, (1.0 + torch.abs(c)).amax(0))
    h_scale = _fmax(h[0] * 0.0 + 1.0, (1.0 + torch.abs(h)).amax(0))
    return obj_scale, h_scale


def _seq_sum(terms):
    """terms[0] + terms[1] + ... left to right (the kernels' order)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _matvec(A, v):
    """(A v)_r = A[r, 0] v[0] + A[r, 1] v[1] + ... in that order; A (R, C,
    B), v (C, B) -> (R, B)."""
    acc = A[:, 0] * v[0]
    for j in range(1, A.shape[1]):
        acc = acc + A[:, j] * v[j]
    return acc


# ---------------------------------------------------------------------------
# K3a: the barrier (plain PyTorch version of csrc/qct_dense_ipm.cuh
# dense_barrier_lanes, whose serial form is dense_barrier_instance, and of
# pallas_ipm.py::_kernel)
# ---------------------------------------------------------------------------

def _dense_barrier_plain(Qp, cp, Gp, hp, *, iterations: int, tau: float):
    """Fixed-iteration Mehrotra loop on the equilibrated ``(k, B)`` problem.
    Returns the best iterate ``(x (12, B), s (24, B), z (24, B))``."""
    B = cp.shape[1]
    Q = Qp.reshape(N, N, B)
    G = Gp.reshape(M, N, B)
    c, h = cp, hp
    d_max = _f32(1.0 / _EPS)
    upper = torch.ones(N, N, dtype=torch.bool, device=c.device).triu()
    diag = torch.arange(N, device=c.device)

    x = torch.zeros_like(c)
    s = _fmax(h, 1.0)
    z = torch.ones_like(s) / s
    obj_scale, h_scale = _scales(c, h)
    freeze_gap = _f32(100.0 * _EPS) * obj_scale
    freeze_pr = _f32(50.0 * _EPS) * h_scale
    freeze_dr = _f32(50.0 * _EPS) * obj_scale

    def chol_solve(L, rhs):
        # Forward by columns (row i still subtracts its terms in increasing
        # k), backward by rows.
        acc = rhs.clone()
        y = torch.empty_like(rhs)
        for k in range(N):
            y[k] = acc[k] * L[k, k]          # L[k, k] stores 1/L_kk
            if k + 1 < N:
                acc[k + 1:] = acc[k + 1:] - L[k + 1:, k] * y[k]
        u = [None] * N
        for i in reversed(range(N)):
            v = y[i]
            for k in range(i + 1, N):
                v = v - L[k, i] * u[k]
            u[i] = v * L[i, i]
        return torch.stack(u)

    bx = torch.zeros_like(x)
    bs, bz = s, z
    bmerit = torch.full_like(c[0], float("inf"))
    for _ in range(iterations):
        r_prim = _matvec(G, x) + s - h
        r_dual = c
        for j in range(N):
            r_dual = r_dual + Q[:, j] * x[j]
        for r in range(M):
            r_dual = r_dual + G[r] * z[r]

        d = _fmin(z / s, d_max)
        # M = Q + G^T D G; only the upper triangle is read.
        Mm = Q
        for r in range(M):
            Mm = Mm + (G[r][:, None] * d[r]) * G[r][None, :]
        diag_max = Mm[diag, diag].amax(0)
        delta = _f32(100.0 * _EPS) * diag_max
        Mm = Mm.clone()
        Mm[diag, diag] = Mm[diag, diag] + delta

        L = torch.zeros_like(Mm)
        for j in range(N):
            dd = Mm[j, j]
            for k in range(j):
                dd = dd - L[j, k] * L[j, k]
            dd = torch.where(dd > 0.0, dd, _NAN)
            inv = _rsqrt(dd)
            L[j, j] = inv
            if j + 1 < N:
                v = Mm[j, j + 1:]
                for k in range(j):
                    v = v - L[j + 1:, k] * L[j, k]
                L[j + 1:, j] = v * inv

        # The un-regularised M, symmetric, for the refinement pass.
        Mt = torch.where(upper[:, :, None], Mm, Mm.transpose(0, 1))
        Mt[diag, diag] = Mm[diag, diag] - delta

        def kkt_solve(rhs):
            u = chol_solve(L, rhs)
            resid = rhs
            for j in range(N):
                resid = resid - Mt[:, j] * u[j]
            return u + chol_solve(L, resid)

        mu = _seq_sum(list(s * z)) * (1.0 / M)

        def newton(rc):
            t = (z * r_prim - rc) / s
            rhs = -r_dual
            for r in range(M):
                rhs = rhs - G[r] * t[r]
            dx = kkt_solve(rhs)
            ds = -r_prim - _matvec(G, dx)
            dz = -(rc + z * ds) / s
            return dx, ds, dz

        def max_step(v, dv, t_frac):
            neg = dv < 0.0
            rr = torch.where(neg, -v / torch.where(neg, dv, -1.0), _BIG)
            ratio = _fmin(torch.full_like(v[0], _BIG), rr.amin(0))
            return _fmin(t_frac * ratio, 1.0)

        dx_a, ds_a, dz_a = newton(s * z)
        a_aff = _fmin(max_step(s, ds_a, 1.0), max_step(z, dz_a, 1.0))
        mu_aff = _seq_sum(list((s + a_aff * ds_a) * (z + a_aff * dz_a)))
        mu_aff = mu_aff * (1.0 / M)
        ratio = mu_aff / _fmax(mu, 1e-30)
        sigma_mu = ratio * ratio * ratio * mu

        dx, ds, dz = newton(s * z + ds_a * dz_a - sigma_mu)
        alpha = _fmin(max_step(s, ds, tau), max_step(z, dz, tau))

        pr_max = torch.abs(r_prim).amax(0)
        dr_max = torch.abs(r_dual).amax(0)
        done = (mu < freeze_gap) & (pr_max < freeze_pr) & (dr_max < freeze_dr)

        merit = pr_max / h_scale + dr_max / obj_scale + mu / obj_scale
        improve = (merit < bmerit) & torch.isfinite(x).all(0)
        bx = torch.where(improve, x, bx)
        bs = torch.where(improve, s, bs)
        bz = torch.where(improve, z, bz)
        bmerit = torch.where(improve, merit, bmerit)

        finite = (torch.isfinite(dx).all(0) & torch.isfinite(ds).all(0)
                  & torch.isfinite(dz).all(0))
        # a == 0 with a non-finite direction gives 0 * NaN = NaN on purpose:
        # the lane is poisoned and its best iterate stands.
        a = torch.where(done | ~finite, 0.0, alpha)
        x = x + a * dx
        s = _fmax(s + a * ds, _TINY)
        z = _fmax(z + a * dz, _TINY)
    return bx, bs, bz


# ---------------------------------------------------------------------------
# K3b: the certified polish (plain PyTorch version of csrc/qct_dense_ipm.cuh
# dense_polish_lanes and of pallas_ipm.py::_polish_kernel)
# ---------------------------------------------------------------------------

def _dense_polish_plain(Qp, cp, Gp, hp, xin, sin, zin,
                        sweeps: int = _POLISH_SWEEPS_PALLAS,
                        refine: int = _POLISH_REFINE):
    """Certified active-set polish of the equilibrated ``(k, B)`` problem
    from ``(xin, sin, zin)``. Returns ``(x, s, z, cert (B,))``."""
    B = cp.shape[1]
    Q = Qp.reshape(N, N, B)
    G = Gp.reshape(M, N, B)
    c, h = cp, hp
    reg = _f32(1e-4)
    obj_scale, h_scale = _scales(c, h)
    zmax = zin.amax(0)
    tol6 = max(_f32(1e-6), _f32(30.0 * _EPS))
    cert_dr = _f32(30.0 * _EPS) * obj_scale
    feas_tol = tol6 * h_scale
    z_tol = tol6 * (1.0 + zmax)
    ones_M = torch.ones_like(hp)

    def ldl_solve(L, D, rhs):
        u = rhs.clone()
        for k in range(NK - 1):       # forward, by columns
            u[k + 1:] = u[k + 1:] - L[k + 1:, k] * u[k]
        out = [None] * NK
        for i in reversed(range(NK)):  # backward, by rows
            v = u[i] / D[i]
            for k in range(i + 1, NK):
                v = v - L[k, i] * out[k]
            out[i] = v
        return torch.stack(out)

    a = torch.where(zin > sin, 1.0, 0.0)
    bx, bs, bz = xin, sin, zin
    cert = torch.zeros_like(c[0])
    rhs1 = -c
    for _ in range(sweeps):
        aG = a[:, None] * G                       # (M, N, B): a_r G_ri
        # K = [[Q, (aG)^T], [aG, -R]], R = reg a + (1 - a); the LDL^T reads
        # the originals from the upper triangle and writes L below it.
        K = torch.zeros((NK, NK, B), dtype=c.dtype, device=c.device)
        K[:N, :N] = Q
        K[:N, N:] = aG.permute(1, 0, 2)
        K[N:, :N] = aG
        rr = torch.arange(M, device=c.device) + N
        K[rr, rr] = -(reg * a + (1.0 - a))
        D = torch.empty((NK, B), dtype=c.dtype, device=c.device)
        for j in range(NK):
            dd = K[j, j]
            for k in range(j):
                dd = dd - K[j, k] * K[j, k] * D[k]
            dd = torch.where(torch.abs(dd) > 1e-30, dd, _NAN)
            D[j] = dd
            dinv = torch.ones_like(dd) / dd
            if j + 1 < NK:
                v = K[j, j + 1:]
                for k in range(j):
                    v = v - K[j + 1:, k] * D[k] * K[j, k]
                K[j + 1:, j] = v * dinv

        rhs2 = a * h
        u = ldl_solve(K, D, torch.cat([rhs1, rhs2]))
        xp, zp = u[:N], u[N:]
        for _ in range(refine):
            r1 = rhs1
            for j in range(N):
                r1 = r1 - Q[:, j] * xp[j]
            for r in range(M):
                r1 = r1 - aG[r] * zp[r]
            r2 = rhs2 - (1.0 - a) * zp
            for j in range(N):
                r2 = r2 - aG[:, j] * xp[j]
            u = ldl_solve(K, D, torch.cat([r1, r2]))
            xp = xp + u[:N]
            zp = zp + u[N:]

        # Certification: compensated stationarity, feasibility, signs.
        terms = [(-Q[:, j], xp[j]) for j in range(N)]
        terms += [(-aG[r], zp[r]) for r in range(M)]
        terms.append((torch.ones_like(rhs1), rhs1))
        r1 = _ff_linear(terms)
        dr_max = torch.abs(r1).amax(0)
        slack = h
        for j in range(N):
            slack = slack - G[:, j] * xp[j]
        slack_min = slack.amin(0)
        z_signed = (zp * a).amin(0)
        finite = torch.isfinite(xp).all(0) & torch.isfinite(zp).all(0)
        ok = (finite & (slack_min > -feas_tol) & (z_signed > -z_tol)
              & (dr_max < cert_dr))

        take = ok & (cert < 0.5)
        bx = torch.where(take, xp, bx)
        bz = torch.where(take, _fmax(a * zp, 0.0), bz)
        bs = torch.where(take, _fmax(slack, 0.0), bs)
        cert = _fmax(cert, ok.to(cert.dtype))

        # Add the most violated inactive row, else drop the most negative
        # multiplier; strict comparisons keep the first index on ties.
        viol_best = torch.full_like(cert, -_BIG)
        viol_idx = torch.zeros_like(cert)
        negz_best = torch.full_like(cert, _BIG)
        negz_idx = torch.zeros_like(cert)
        for r in range(M):
            active = a[r] > 0.5
            viol_r = torch.where(active, -_BIG, -slack[r])
            upd = viol_r > viol_best
            viol_best = torch.where(upd, viol_r, viol_best)
            viol_idx = torch.where(upd, float(r), viol_idx)
            nz_r = torch.where(active, zp[r], _BIG)
            updn = nz_r < negz_best
            negz_best = torch.where(updn, nz_r, negz_best)
            negz_idx = torch.where(updn, float(r), negz_idx)
        do_add = viol_best > feas_tol
        do_drop = ~do_add & (negz_best < -z_tol)
        rows = torch.arange(M, dtype=cert.dtype, device=c.device)[:, None]
        a_new = torch.where(do_add & (viol_idx == rows), ones_M,
                            torch.where(do_drop & (negz_idx == rows), 0.0, a))
        a = torch.where(cert > 0.5, a, a_new)
    return bx, bs, bz, cert


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel
# ---------------------------------------------------------------------------

def _check_problem(Qp, cp, Gp, hp):
    B = cp.shape[1]
    for name, a, k in (("Q", Qp, N * N), ("c", cp, N), ("G", Gp, M * N),
                       ("h", hp, M)):
        _check_soa(name, a, k, B, cp.device)
    return B


def dense_barrier(Qp, cp, Gp, hp, *, iterations: int = 20,
                  tau: float = 0.995):
    """K3a on equilibrated ``(k, B)`` float32 tensors. Returns ``(x, s,
    z)``, the best iterate. CUDA tensors launch the kernel (counted in
    ``kernels.launch_counts["qct_dense_barrier"]``); CPU tensors run
    :func:`_dense_barrier_plain`."""
    _check_problem(Qp, cp, Gp, hp)
    if cp.device.type == "cpu":
        return _dense_barrier_plain(Qp, cp, Gp, hp, iterations=int(iterations),
                                    tau=float(tau))
    return kernels.dense_barrier(Qp, cp, Gp, hp, iterations=int(iterations),
                                 tau=float(tau))


def dense_polish(Qp, cp, Gp, hp, x, s, z):
    """K3b on equilibrated ``(k, B)`` float32 tensors from the point ``(x,
    s, z)``. Returns ``(x, s, z, cert (B,))`` (cert 1.0 where the polish
    certified). CUDA tensors launch the kernel
    (``kernels.launch_counts["qct_dense_polish"]``); CPU tensors run
    :func:`_dense_polish_plain`."""
    B = _check_problem(Qp, cp, Gp, hp)
    for name, a, k in (("x", x, N), ("s", s, M), ("z", z, M)):
        _check_soa(name, a, k, B, cp.device)
    if cp.device.type == "cpu":
        return _dense_polish_plain(Qp, cp, Gp, hp, x, s, z)
    return kernels.dense_polish(Qp, cp, Gp, hp, x, s, z)


def solve_qp_ipm_fused(Q, c, G, h, iterations: int = 20, tol: float = 3e-5,
                       tau: float = 0.995, polish: bool = True,
                       device=None) -> IPMSolution:
    """Batched dense QP solve (n = 12, m = 24) in the dense IPM kernels:
    the counterpart of ``solve_qp_ipm_pallas`` and a drop-in for
    ``solver/ipm.solve_qp_ipm``.

    Any batch shape ``Q (..., 12, 12)``, ``c (..., 12)``, ``G (..., 24,
    12)``, ``h (..., 24)`` (the JAX entry needs B % 1024 == 0; here the
    kernels mask the ragged edge). Equilibrates, runs the barrier (K3a) and,
    if ``polish``, the certified polish (K3b) on its output, then maps back
    to original units and reports ``gap``, ``primal_residual``,
    ``dual_residual`` and ``converged = loose KKT at tol | certified``.
    ``device`` (default ``cuda``) is where the solve runs: the kernels on a
    card, their plain PyTorch versions on the CPU."""
    kernels.refuse_grad("solve_qp_ipm_fused", Q, c, G, h)
    dev = resolve_device(device)
    Q, c, G, h = (torch.as_tensor(a, device=dev) for a in (Q, c, G, h))
    if Q.shape[-2:] != (N, N) or G.shape[-2:] != (M, N):
        raise ValueError(f"expected Q (..., {N}, {N}) and G (..., {M}, {N}); "
                         f"got {tuple(Q.shape)} and {tuple(G.shape)}")
    batch = tuple(Q.shape[:-2])
    B = 1
    for d in batch:
        B *= int(d)
    Q, c = Q.reshape(B, N, N), c.reshape(B, N)
    G, h = G.reshape(B, M, N), h.reshape(B, M)
    Qs, cs, Gs, hs, Dv, Er, nu = equilibrate(Q, c, G, h)
    prob = (_soa(Qs, N * N, B), _soa(cs, N, B), _soa(Gs, M * N, B),
            _soa(hs, M, B))
    xp, sp, zp = dense_barrier(*prob, iterations=iterations, tau=tau)
    certified = None
    if polish:
        xp, sp, zp, cert = dense_polish(*prob, xp, sp, zp)
        certified = cert > 0.5

    x = xp.t() * Dv
    z = zp.t() * Er / nu[..., None]
    s = sp.t() / Er
    r_dual = _mv(Q, x) + c + _mtv(G, z)
    r_prim = _mv(G, x) + s - h
    gap = torch.abs(torch.sum(s * z, dim=-1)) / M
    scale = 1.0 + _amax(torch.abs(c))
    pr = _amax(torch.abs(r_prim))
    dr = _amax(torch.abs(r_dual))
    converged = ((pr < tol * (1.0 + _amax(torch.abs(h))))
                 & (dr < tol * scale) & (gap < tol * scale))
    if certified is not None:
        converged = converged | certified
    return IPMSolution(
        x=x.reshape(batch + (N,)), z=z.reshape(batch + (M,)),
        s=s.reshape(batch + (M,)), iterations=torch.as_tensor(iterations),
        gap=gap.reshape(batch), primal_residual=pr.reshape(batch),
        dual_residual=dr.reshape(batch), converged=converged.reshape(batch))


def solve_qp_prox_fused(Q, c, G, h, x0, rho_rel: float = 1e-2,
                        prox_steps: int = 4, iterations: int = 30,
                        tol: float = 3e-5, device=None) -> IPMSolution:
    """Proximal restarts of :func:`solve_qp_ipm_fused` certified against the
    ORIGINAL KKT: the dense stage of ``solve_balance_qp_fused(prox_tail=True,
    prox_backend="xla")`` (pallas_fused.py:1700-1729). ``rho = rho_rel *
    mean(diag Q)`` per instance; each restart solves ``Q + rho I`` with ``c
    - rho x_k`` (20 → ``iterations`` barrier iterations, polish on) from the
    previous restart's ``x``; ``x0`` seeds the first. ``converged`` is the
    loose KKT test of the ORIGINAL problem at ``tol``."""
    dev = resolve_device(device)
    Q, c, G, h, xk = (torch.as_tensor(a, device=dev)
                      for a in (Q, c, G, h, x0))
    rho = rho_rel * torch.diagonal(Q, dim1=-2, dim2=-1).mean(-1)[..., None]
    Qp = Q + rho[..., None] * torch.eye(N, dtype=Q.dtype, device=dev)
    ps = None
    for _ in range(prox_steps):
        ps = solve_qp_ipm_fused(Qp, c - rho * xk, G, h, iterations=iterations,
                                polish=True, tol=tol, device=dev)
        xk = ps.x
    pr = _amax(torch.abs(_mv(G, xk) + ps.s - h))
    dr = _amax(torch.abs(_mv(Q, xk) + c + _mtv(G, ps.z)))
    gap = torch.abs(torch.sum(ps.s * ps.z, dim=-1)) / M
    scalec = 1.0 + _amax(torch.abs(c))
    hmax = 1.0 + _amax(torch.abs(h))
    conv = (pr < tol * hmax) & (dr < tol * scalec) & (gap < tol * scalec)
    return IPMSolution(x=xk, z=ps.z, s=ps.s, iterations=ps.iterations,
                       gap=gap, primal_residual=pr, dual_residual=dr,
                       converged=conv)
