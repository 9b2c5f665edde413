"""Float64 host-side QP oracle: a dense primal active-set solver.

Plays the role qpOASES plays for the reference (balance_controller.cpp:
177-208): the ground-truth active-set solution the batched TPU interior-point
solver must match. Pure NumPy, float64, Nocedal & Wright Alg. 16.3 (primal
active set for strictly convex QP), with a KKT self-check so every oracle
solution is independently certified optimal — no circular trust in either
solver.

Problem form matches ops/dynamics.py: min 1/2 x^T Q x + c^T x, G x <= h.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ActiveSetSolution(NamedTuple):
    x: np.ndarray
    lam: np.ndarray  # multipliers for all m constraints (0 if inactive)
    active: np.ndarray  # bool mask of the final working set
    iterations: int
    status: str  # "optimal" | "max_iter"
    kkt_error: float  # certified max KKT residual


def _eqp_solve(Q, c, G_w, h_w):
    """Equality-constrained QP via the full KKT system (f64 direct solve)."""
    n = Q.shape[0]
    k = G_w.shape[0]
    if k == 0:
        return np.linalg.solve(Q, -c), np.zeros(0)
    KKT = np.zeros((n + k, n + k))
    KKT[:n, :n] = Q
    KKT[:n, n:] = G_w.T
    KKT[n:, :n] = G_w
    rhs = np.concatenate([-c, h_w])
    sol = np.linalg.solve(KKT, rhs)
    return sol[:n], sol[n:]


def kkt_error(Q, c, G, h, x, lam, tol_comp=1e-9):
    """Max KKT residual: stationarity, primal/dual feasibility,
    complementarity. Small value certifies global optimality (convex QP)."""
    stationarity = np.max(np.abs(Q @ x + c + G.T @ lam))
    primal = np.max(np.maximum(G @ x - h, 0.0), initial=0.0)
    dual = np.max(np.maximum(-lam, 0.0), initial=0.0)
    comp = np.max(np.abs(lam * (G @ x - h)), initial=0.0)
    return max(stationarity, primal, dual, comp)


def solve_qp_active_set(
    Q: np.ndarray,
    c: np.ndarray,
    G: np.ndarray,
    h: np.ndarray,
    x0: Optional[np.ndarray] = None,
    max_iter: int = 200,
    feas_tol: float = 1e-10,
) -> ActiveSetSolution:
    """Solve one QP in float64. ``x0`` must be feasible; if omitted, a
    feasible point is found by shifting the unconstrained minimizer (works
    whenever the feasible set has nonempty interior reachable by backtracking
    toward a caller-supplied interior heuristic — for the GRF family use
    :func:`grf_feasible_point`)."""
    Q = np.asarray(Q, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    m, n = G.shape

    if x0 is None:
        raise ValueError("active-set oracle needs a feasible starting point")
    x = np.asarray(x0, dtype=np.float64).copy()
    if np.any(G @ x - h > feas_tol):
        raise ValueError("x0 is not feasible")

    # Working set: start from constraints active at x0.
    active = (G @ x - h) > -1e-12

    for it in range(max_iter):
        idx = np.flatnonzero(active)
        x_eq, lam_w = _eqp_solve(Q, c, G[idx], h[idx])
        p = x_eq - x

        if np.max(np.abs(p)) < 1e-12:
            # Stationary on the working set; check multiplier signs.
            if lam_w.size == 0 or np.min(lam_w) >= -1e-11:
                lam = np.zeros(m)
                lam[idx] = np.maximum(lam_w, 0.0)
                return ActiveSetSolution(
                    x=x, lam=lam, active=active, iterations=it,
                    status="optimal", kkt_error=kkt_error(Q, c, G, h, x, lam),
                )
            # Drop the most negative multiplier.
            drop = idx[np.argmin(lam_w)]
            active[drop] = False
            continue

        # Step toward x_eq; find blocking constraint among inactive rows.
        Gp = G @ p
        slack = h - G @ x
        blocking = (~active) & (Gp > 1e-14)
        alpha = 1.0
        block_idx = -1
        if np.any(blocking):
            ratios = np.full(m, np.inf)
            ratios[blocking] = slack[blocking] / Gp[blocking]
            j = int(np.argmin(ratios))
            if ratios[j] < alpha:
                alpha = max(ratios[j], 0.0)
                block_idx = j
        x = x + alpha * p
        if block_idx >= 0:
            active[block_idx] = True

    lam = np.zeros(m)
    idx = np.flatnonzero(active)
    if idx.size:
        _, lam_w = _eqp_solve(Q, c, G[idx], h[idx])
        lam[idx] = lam_w
    return ActiveSetSolution(
        x=x, lam=lam, active=active, iterations=max_iter,
        status="max_iter", kkt_error=kkt_error(Q, c, G, h, x, lam),
    )


def grf_feasible_point(stance_mask: np.ndarray, fz_min: float, fz_max: float,
                       n: int = 12) -> np.ndarray:
    """Strictly feasible start for the GRF cone QP: zero tangential force,
    mid-range normal force on stance legs, zero on swing legs."""
    x = np.zeros(n)
    fz = 0.5 * (fz_min + fz_max)
    for leg in range(4):
        if stance_mask[leg]:
            x[3 * leg + 2] = fz
    return x


class FlatnessCertificate(NamedTuple):
    """Per-instance certificate for an f32 answer that differs from the
    unique f64 optimum (Q is strictly convex, so literal optimal-set
    multiplicity cannot occur — what DOES occur in the 4-stance family is
    an f32-FLAT valley: the regularizer ``w_diag`` is the only curvature
    in the 6-dim null space of the stacked SRB rows, so N-scale force
    moves cost ~1e-8 relative objective).

    ``obj_rel_gap``: relative objective of the f32 answer above the f64
    optimum. ``dist``: ||x_f32 - x*||. ``curv_rel``: the certified
    curvature statement — (1/2) d^T Q d / (1 + |f*|) for the unit-free
    displacement d = x_f32 - x*; when this matches ``obj_rel_gap`` the
    entire displacement lies in the flat valley (linear terms cancel at
    the optimum up to active-set effects). ``n_weak_active``: active
    oracle rows with multiplier < 1e-7 — the degeneracy witnesses (a
    vertex with zero multipliers can be left without first-order cost).
    ``flat``: obj_rel_gap <= tol — the f32 answer is optimal to the
    certification tolerance even if its KKT flag or its force vector
    disagrees with the oracle vertex."""

    obj_rel_gap: float
    dist: float
    curv_rel: float
    n_weak_active: int
    flat: bool


def certify_flatness(Q, c, G, h, x_f32, stance_mask,
                     fz_min=10.0, fz_max=120.0, tol=1e-6):
    """Certificates for a batch of f32 answers vs the f64 oracle.

    Returns (certs, x_star, obj_star): a list of
    :class:`FlatnessCertificate` plus the oracle solutions — the
    instrument for the bench tail (instances whose loose conv flag failed)
    and for the N-scale force-diff parity note (VERDICT round-4 #5)."""
    Q, c, G, h = (np.asarray(a, dtype=np.float64) for a in (Q, c, G, h))
    x_f32 = np.asarray(x_f32, dtype=np.float64)
    stance_mask = np.asarray(stance_mask)
    certs, xs, objs = [], [], []
    for i in range(Q.shape[0]):
        x0 = grf_feasible_point(stance_mask[i], fz_min, fz_max)
        sol = solve_qp_active_set(Q[i], c[i], G[i], h[i], x0=x0)
        f_star = 0.5 * sol.x @ Q[i] @ sol.x + c[i] @ sol.x
        f_32 = 0.5 * x_f32[i] @ Q[i] @ x_f32[i] + c[i] @ x_f32[i]
        scale = 1.0 + abs(f_star)
        gap = (f_32 - f_star) / scale
        d = x_f32[i] - sol.x
        curv = 0.5 * d @ Q[i] @ d / scale
        weak = int(np.sum(sol.active & (sol.lam < 1e-7)))
        certs.append(FlatnessCertificate(
            obj_rel_gap=float(gap), dist=float(np.linalg.norm(d)),
            curv_rel=float(curv), n_weak_active=weak,
            flat=bool(abs(gap) <= tol)))
        xs.append(sol.x)
        objs.append(f_star)
    return certs, np.array(xs), np.array(objs)


def solve_qp_batch_oracle(Q, c, G, h, stance_mask, fz_min=10.0, fz_max=120.0):
    """Loop the oracle over a batch (host-side validation path).

    Returns (x, objective, kkt_err) stacked over the batch.
    """
    Q, c, G, h = (np.asarray(a, dtype=np.float64) for a in (Q, c, G, h))
    stance_mask = np.asarray(stance_mask)
    batch = Q.shape[:-2]
    Qf = Q.reshape((-1,) + Q.shape[-2:])
    cf = c.reshape((-1,) + c.shape[-1:])
    Gf = G.reshape((-1,) + G.shape[-2:])
    hf = h.reshape((-1,) + h.shape[-1:])
    sf = stance_mask.reshape((-1, stance_mask.shape[-1]))

    xs, objs, errs = [], [], []
    for i in range(Qf.shape[0]):
        x0 = grf_feasible_point(sf[i], fz_min, fz_max)
        sol = solve_qp_active_set(Qf[i], cf[i], Gf[i], hf[i], x0=x0)
        xs.append(sol.x)
        objs.append(0.5 * sol.x @ Qf[i] @ sol.x + cf[i] @ sol.x)
        errs.append(sol.kkt_error)
    return (
        np.array(xs).reshape(batch + (Q.shape[-1],)),
        np.array(objs).reshape(batch),
        np.array(errs).reshape(batch),
    )
