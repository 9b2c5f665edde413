"""Plain reference of the balance controller's GRF QP: the QP assembled from
raw scenario state (PD accelerations, the single-rigid-body Newton-Euler
system, the friction cone; balance_controller.cpp of bostoncleek/
quadruped_control, with swing legs eliminated by masking A's columns and
their cone rows relaxed), and a batched primal-dual interior-point solve.

Written from the configuration file's numbers and the published equations;
imports nothing of the program. In ``float64`` it is the yardstick; in
``tf32`` (see precision.py) it is the control."""

import math

import torch

from .precision import Arith

N, M = 12, 24
SWING_ROW_RELAX = 1.0e4


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_log(R):
    """Rotation vector of R (angle below pi: the scenarios' tilts)."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    sin = 0.5 * torch.linalg.norm(w, dim=-1)
    cos = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    th = torch.atan2(sin, cos)
    small = th < 1e-7
    scale = torch.where(small, 0.5 * (1.0 + th * th / 6.0),
                        0.5 * th / torch.where(small, 1.0, sin))
    return w * scale[..., None]


def balance_qp(scen: dict, bal: dict, ar: Arith):
    """(Q, c, G, h) of each scenario: min 1/2 f'Qf + c'f s.t. Gf <= h with
    Q = 2 (A'SA + W), c = -2 A'S b, G f <= h the 24 one-sided cone rows."""
    dt = ar.dtype
    g = {k: ar.r(v.to(dt)) for k, v in scen.items() if k != "stance"}
    st = scen["stance"].bool()
    dev = st.device
    kw = dict(dtype=dt, device=dev)

    def vec(key):
        return torch.tensor(bal[key], **kw)

    xdd = vec("kp_p") * (g["x_d"] - g["x"]) + vec("kd_p") * (
        g["xdot_d"] - g["xdot"])
    kff = bal["kff"]
    xdd = xdd + torch.stack([
        kff[0] * g["xdot_d"][..., 0], kff[1] * g["xdot_d"][..., 1],
        torch.full_like(g["x"][..., 0], kff[2] * bal["mass"] * 9.81)], -1)
    R, Rd = g["R"], g["R_d"]
    Rerr = ar.mm(Rd, R.transpose(-1, -2))
    wdd = vec("kp_w") * _so3_log(Rerr) + vec("kd_w") * (g["w_d"] - g["w"])
    wdd = wdd + torch.stack([
        kff[3] * g["w_d"][..., 0],
        kff[4] * g["w_d"][..., 1] + kff[5] * g["w_d"][..., 2],
        torch.zeros_like(g["w_d"][..., 2])], -1)

    feet_w = ar.mm(R[:, None], g["feet"][..., None])[..., 0]   # (B, 4, 3)
    feet_w = torch.where(st[..., None], feet_w, 0.0)
    B = R.shape[0]
    eye = torch.eye(3, **kw).expand(B, 4, 3, 3) * st[..., None, None]
    A = torch.cat([torch.cat([eye[:, l] for l in range(4)], -1),
                   torch.cat([_skew(feet_w[:, l]) for l in range(4)], -1)],
                  -2)                                           # (B, 6, 12)
    Ib = torch.tensor(bal["inertia_diag"], **kw)
    Iw = ar.mm(R * Ib, R.transpose(-1, -2))
    Iw_wd = ar.mm(Iw, g["w_d"][..., None])[..., 0]
    b = torch.cat([bal["mass"] * (xdd + torch.tensor(
        [0.0, 0.0, bal["gravity_z_term"]], **kw)),
        ar.mm(Iw, wdd[..., None])[..., 0]
        + torch.linalg.cross(g["w_d"], Iw_wd)], -1)             # (B, 6)

    S = torch.tensor(bal["s_diag"], **kw)
    SA = S[:, None] * A
    Q = 2.0 * ar.mm(A.transpose(-1, -2), SA) + 2.0 * bal["w_diag"] * \
        torch.eye(N, **kw)
    c = -2.0 * ar.mm(SA.transpose(-1, -2), b[..., None])[..., 0]

    mu = bal["mu"]
    leg = torch.tensor([[1.0, 0.0, -mu], [0.0, 1.0, -mu], [0.0, -1.0, -mu],
                        [-1.0, 0.0, -mu], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]],
                       **kw)
    G = torch.zeros((B, M, N), **kw)
    for l in range(4):
        G[:, 6 * l:6 * l + 6, 3 * l:3 * l + 3] = leg
    h_leg = torch.tensor([0.0, 0.0, 0.0, 0.0, bal["fz_max"], -bal["fz_min"]],
                         **kw).repeat(4)
    h = torch.where(st.repeat_interleave(6, -1), h_leg, SWING_ROW_RELAX)
    return tuple(ar.r(a) for a in (Q, c, G, h))


def solve(Q, c, G, h, ar: Arith, iterations: int = 150, tol: float = 1e-10):
    """Mehrotra predictor-corrector interior-point solve of the batch.
    Returns (x, converged). A lane whose step is not finite (its KKT matrix
    stopped factoring) keeps its last iterate; only the control's precision
    runs into that. In float64 the result is then polished on its active
    set (:func:`polish`)."""
    Bn = Q.shape[0]
    x = torch.zeros((Bn, N), dtype=Q.dtype, device=Q.device)
    s = torch.clamp(h - (G @ x[..., None])[..., 0], min=1.0)
    z = torch.ones_like(s)
    live = torch.ones(Bn, dtype=torch.bool, device=Q.device)
    scale = 1.0 + c.abs().amax(-1)
    hs = 1.0 + h.abs().amax(-1)
    Gt = G.transpose(-1, -2)
    eye = torch.eye(N, dtype=Q.dtype, device=Q.device)
    tiny = torch.finfo(Q.dtype).tiny
    conv = torch.zeros_like(live)
    for _ in range(iterations):
        rd = (ar.mm(Q, x[..., None])[..., 0] + c
              + ar.mm(Gt, z[..., None])[..., 0])
        rp = ar.mm(G, x[..., None])[..., 0] + s - h
        mu = (s * z).sum(-1) / M
        conv = ((rd.abs().amax(-1) < tol * scale)
                & (rp.abs().amax(-1) < tol * hs) & (mu < tol * scale))
        live = live & ~conv
        if not bool(live.any()):
            break
        K = Q + ar.mm(Gt * (z / s)[:, None, :], G)
        L, info = torch.linalg.cholesky_ex(K)
        ok = (info == 0) & torch.isfinite(L).all(-1).all(-1)
        live = live & ok
        L = torch.where(ok[:, None, None], L, eye)

        def direction(rc):
            rhs = -rd - ar.mm(Gt, ((z * rp - rc) / s)[..., None])[..., 0]
            dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            ds = -rp - ar.mm(G, dx[..., None])[..., 0]
            dz = -(rc + z * ds) / s
            return dx, ds, dz

        def step(v, dv):
            ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, math.inf))
            return torch.clamp(ratio.amin(-1), max=1.0)

        dx, ds, dz = direction(s * z)
        a_aff = torch.minimum(step(s, ds), step(z, dz))
        mu_aff = ((s + a_aff[:, None] * ds) * (z + a_aff[:, None] * dz)
                  ).sum(-1) / M
        sigma = (mu_aff / mu) ** 3
        dx, ds, dz = direction(s * z + ds * dz - (sigma * mu)[:, None])
        a = (0.99 * torch.minimum(step(s, ds), step(z, dz)))[:, None]
        fin = (torch.isfinite(dx).all(-1) & torch.isfinite(ds).all(-1)
               & torch.isfinite(dz).all(-1) & torch.isfinite(a[:, 0]))
        live = live & fin
        keep = live[:, None]
        x = torch.where(keep, x + a * dx, x)
        s = torch.where(keep, torch.clamp(s + a * ds, min=tiny), s)
        z = torch.where(keep, torch.clamp(z + a * dz, min=tiny), z)
    if ar.name == "float64":
        x, exact = polish(Q, c, G, h, x, s, z)
        conv = conv | exact
        rest = torch.nonzero(~conv).flatten().tolist()
        if rest:
            x = x.clone()
            conv = conv.clone()
            for i in rest:
                xi, ok = active_set(*(a[i].cpu().numpy()
                                      for a in (Q, c, G, h)))
                x[i] = torch.as_tensor(xi, dtype=x.dtype, device=x.device)
                conv[i] = ok
    return x, conv


def polish(Q, c, G, h, x, s, z):
    """Solve each lane's equality QP on the active set the interior point
    names (z > s) exactly, and keep that point where it is feasible, its
    multipliers are non-negative and its objective is no worse: the
    interior point's last digits, at the degenerate lanes its last
    percent, become the optimum's. Returns (x, polished)."""
    Bn = Q.shape[0]
    act = (z > s).to(Q.dtype)                                  # (B, M)
    Ga = G * act[..., None]
    K = torch.zeros((Bn, N + M, N + M), dtype=Q.dtype, device=Q.device)
    K[:, :N, :N] = Q
    K[:, :N, N:] = Ga.transpose(-1, -2)
    K[:, N:, :N] = Ga
    K[:, N:, N:] = torch.diag_embed(1.0 - act)       # inactive: lambda = 0
    rhs = torch.cat([-c, h * act], -1)
    sol = (torch.linalg.pinv(K) @ rhs[..., None])[..., 0]
    xp, lam = sol[:, :N], sol[:, N:]
    hs = 1.0 + h.abs().amax(-1)
    feas = ((G @ xp[..., None])[..., 0] - h).amax(-1) <= 1e-12 * hs
    dual = lam.amin(-1) >= -1e-9 * (1.0 + lam.abs().amax(-1))
    better = objective(Q, c, xp) <= objective(Q, c, x) + 1e-13 * (
        1.0 + objective(Q, c, x).abs())
    good = feas & dual & better & torch.isfinite(xp).all(-1)
    return torch.where(good[:, None], xp, x), good


def active_set(Q, c, G, h, iterations: int = 200):
    """One lane by the primal active-set method (Nocedal and Wright,
    Algorithm 16.3) in float64 NumPy, from the feasible point of zero
    tangential and mid-range normal stance forces: the fallback for the few
    lanes the interior point and its polish leave uncertified. Returns (x,
    optimal)."""
    import numpy as np

    m, n = G.shape
    x = np.zeros(n)
    stance = h[np.arange(4) * 6 + 4] < SWING_ROW_RELAX   # fz <= fz_max rows
    x[2::3] = np.where(stance, 0.5 * (h[4::6] - h[5::6]), 0.0)
    work = (G @ x - h) > -1e-12
    for _ in range(iterations):
        idx = np.flatnonzero(work)
        k = idx.size
        K = np.zeros((n + k, n + k))
        K[:n, :n], K[:n, n:], K[n:, :n] = Q, G[idx].T, G[idx]
        sol = np.linalg.lstsq(K, np.concatenate([-c, h[idx]]), rcond=None)[0]
        p, lam = sol[:n] - x, sol[n:]
        if np.abs(p).max() < 1e-12:
            if k == 0 or lam.min() >= -1e-11:
                return x, True
            work[idx[np.argmin(lam)]] = False
            continue
        Gp, slack = G @ p, h - G @ x
        block = ~work & (Gp > 1e-14)
        alpha, j = 1.0, -1
        if block.any():
            ratios = np.where(block, slack / np.where(block, Gp, 1.0), np.inf)
            j = int(np.argmin(ratios))
            if ratios[j] < 1.0:
                alpha = max(ratios[j], 0.0)
            else:
                j = -1
        x = x + alpha * p
        if j >= 0:
            work[j] = True
    return x, False


def objective(Q, c, x):
    """1/2 x'Qx + c'x of each lane, float64."""
    Q, c, x = Q.double(), c.double(), x.double()
    return 0.5 * torch.einsum("bi,bij,bj->b", x, Q, x) + (c * x).sum(-1)


def judge(scen: dict, bal: dict, x):
    """Solve the scenarios by the reference and read the answers ``x`` (B,
    12) against its optimum: the objective gap (f(x) - f*) / (1 + |f*|) and
    the cone violation max(G x - h, 0) in newtons, both per lane, float64.
    Also returns whether the reference itself converged on each lane."""
    ar = Arith("float64")
    Q, c, G, h = balance_qp(scen, bal, ar)
    xs, conv = solve(Q, c, G, h, ar)
    f_star = objective(Q, c, xs)
    xd = x.double()
    gap = (objective(Q, c, xd) - f_star) / (1.0 + f_star.abs())
    viol = torch.clamp((G @ xd[..., None])[..., 0] - h, min=0.0).amax(-1)
    return gap, viol, conv


def control_answers(scen: dict, bal: dict):
    """The control put in the program's place: the reference computed in
    TF32 (float32 storage, every product's operands in TF32), answering
    every scenario."""
    ar = Arith("tf32")
    Q, c, G, h = balance_qp(scen, bal, ar)
    x, _ = solve(Q, c, G, h, ar, tol=3e-5)
    return ar.r(x)
