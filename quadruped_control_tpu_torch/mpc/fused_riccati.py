"""The whole receding-horizon MPC solve as one kernel (K6), and its plain
PyTorch version (counterpart of
``quadruped_control_tpu/mpc/pallas_riccati.py``).

Per instance: the per-step data of the horizon QP assembled from raw SRB
data, the scalings (forces in units of sigma_f = 120 N, cost normalised by
nu = 1 / max |c'| from one adjoint rollout), then a fixed-centering
path-following interior-point method whose Newton step is a backward Riccati
sweep (12x12 LDL^T per step) plus a forward rollout, best-iterate tracking
for N <= 16 (longer horizons keep the final iterate, as the TPU kernel does
for its memory), and an optional warm start from the previous tick.

Entries:
  - :func:`solve_mpc_qp_riccati`: per-instance arrays ``(B, ...)`` (the
    unpacked entry; mass, inertia, mu, fz bounds per instance or scalars);
  - :func:`solve_mpc_qp_riccati_packed`: the ``(k, B)`` MPC precursor block
    that the commander-pre kernel emits (control/fused_commander.py,
    :func:`mpc_block_size` layout), cold or warm — the fused tick's entry;
  - :func:`solve_mpc_fused`: drop-in analogue of mpc/horizon.solve_mpc for
    any batch shape (what ``commander_step(mpc_backend="riccati-pallas")``
    calls).

CUDA tensors launch the CUDA kernel (csrc/qct_mpc.cu, one compiled kernel for
both entries: N, dt, iterations and weights are runtime arguments); CPU
tensors run :func:`_mpc_plain`. There is no 1024-instance tile rule and no
padding: one instance per thread, any batch.
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import GRAVITY, ControlConfig
from quadruped_control_tpu_torch.mpc.horizon import (
    DEFAULT_STATE_WEIGHTS,
    NU,
    NX,
)
from quadruped_control_tpu_torch.ops.dynamics import SWING_ROW_RELAX
from quadruped_control_tpu_torch.solver.ipm import IPMSolution

MC = 24  # cone rows per step
SIGMA_F = 120.0  # force scale (fz_max)
_EPS = 1.1920929e-07
_TRACK_BEST_MAX_N = 16


def mpc_block_size(horizon: int) -> int:
    """Comps of the MPC precursor block: xi0 (13) | levers (12) | stance
    schedule (4N, t-major) | xi_ref (13N, t-major)."""
    return 25 + 17 * horizon


class MpcSettings:
    """Python-float snapshot of the solver's arguments (the CUDA launcher
    copies them into kernels.MpcParams)."""

    def __init__(self, *, n_steps, dt, state_weights=None, alpha=1e-6,
                 iterations=40, sigma_c=0.5, tau=0.95, tol=5e-4,
                 mass=None, inertia_diag=None, mu=None, fz_min=None,
                 fz_max=None):
        self.n_steps = int(n_steps)
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1: {n_steps}")
        self.dt = float(dt)
        w = DEFAULT_STATE_WEIGHTS if state_weights is None else state_weights
        if torch.is_tensor(w) and w.dim() != 1:
            raise ValueError("the MPC kernel takes one state-weight diagonal "
                             "(13,) for the whole batch, got "
                             f"{tuple(w.shape)}")
        self.state_weights = tuple(float(v) for v in w)
        if len(self.state_weights) != NX:
            raise ValueError(f"state_weights: {NX} values, got "
                             f"{len(self.state_weights)}")
        self.alpha = float(alpha)
        self.iterations = int(iterations)
        self.sigma_c = float(sigma_c)
        self.tau = float(tau)
        self.tol = float(tol)
        self.track_best = self.n_steps <= _TRACK_BEST_MAX_N
        self.mass = None if mass is None else float(mass)
        self.inertia_diag = (None if inertia_diag is None
                             else tuple(float(v) for v in inertia_diag))
        self.mu = None if mu is None else float(mu)
        self.fz_min = None if fz_min is None else float(fz_min)
        self.fz_max = None if fz_max is None else float(fz_max)
        self._params = None

    def params(self):
        if self._params is None:
            self._params = kernels.mpc_params(self)
        return self._params


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel.
# ---------------------------------------------------------------------------

def _ldl_factor(Luu):
    """Batched 12x12 LDL^T: (unit-lower L, pivots D). A pivot with |d| <=
    1e-30 becomes NaN (the step it feeds is then rejected)."""
    n = Luu.shape[-1]
    L = torch.zeros_like(Luu)
    D = torch.zeros(Luu.shape[:-1], dtype=Luu.dtype, device=Luu.device)
    for j in range(n):
        Lj = L[:, j, :j]
        dd = Luu[:, j, j] - (Lj * Lj * D[:, :j]).sum(-1)
        dd = torch.where(torch.abs(dd) > 1e-30, dd, float("nan"))
        D[:, j] = dd
        L[:, j, j] = 1.0
        if j + 1 < n:
            v = Luu[:, j + 1:, j] - (L[:, j + 1:, :j] * D[:, None, :j]
                                     * Lj[:, None, :]).sum(-1)
            L[:, j + 1:, j] = v * (1.0 / dd)[:, None]
    return L, D


def _ldl_solve(L, D, rhs):
    """Solve (L D L^T) x = rhs; rhs (B, 12, k)."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y / D[..., None],
                                         upper=True, unitriangular=True)


def _mv(A, x):
    return torch.einsum("bij,bj->bi", A, x)


def _mtv(A, y):
    return torch.einsum("bji,bj->bi", A, y)


def _mpc_plain(yaw, r, m, Ib, mu, fzmin, fzmax, xi0, ref, st, warm,
               st_: MpcSettings):
    """The plain version of K6 on batch-leading tensors.

    Args: yaw (B,), r (B, 4, 3) levers, m (B,), Ib (B, 3), mu / fzmin / fzmax
      (B,), xi0 (B, 13), ref (B, N, 13), st (B, N, 4) float 0/1; warm None or
      (F (B, N, 12) Newtons, s (B, N, 24), z (B, N, 24) original units, the
      schedule they were solved against (B, N, 4), -1 = none).
    Returns: F (B, N, 12) Newtons, diag (B, 6) = [conv, pr, dr, gap, nu, 0],
      warm_out (s, z, F) of the final iterate in original units.
    """
    dtype, device = xi0.dtype, xi0.device
    Bn = xi0.shape[0]
    N = st_.n_steps
    kw = dict(dtype=dtype, device=device)
    sf = SIGMA_F
    eps = _EPS
    d_max = 1.0 / eps
    tiny = 1e-12
    big = 3.0e38
    Lw = torch.tensor(st_.state_weights, **kw)
    dt, g_dt = st_.dt, GRAVITY * st_.dt
    sfdt = SIGMA_F * st_.dt

    # ---- dynamics data ------------------------------------------------------
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    Ixx = cy * cy * Ib[:, 0] + sy * sy * Ib[:, 1]
    Ixy = cy * sy * (Ib[:, 0] - Ib[:, 1])
    Iyy = sy * sy * Ib[:, 0] + cy * cy * Ib[:, 1]
    inv2 = 1.0 / (Ixx * Iyy - Ixy * Ixy)
    zero = torch.zeros_like(yaw)
    W = torch.stack([
        torch.stack([Iyy * inv2, -Ixy * inv2, zero], -1),
        torch.stack([-Ixy * inv2, Ixx * inv2, zero], -1),
        torch.stack([zero, zero, 1.0 / Ib[:, 2]], -1)], -2)
    rz = torch.zeros_like(r[..., 0])
    sk = torch.stack([
        torch.stack([rz, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], rz, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], rz], -1)], -2)  # (B, 4, 3, 3)
    Bw = sfdt * (W[:, None] @ sk)  # (B, 4, 3, 3) [l][c][a]
    # Tensor by tensor where the kernel divides once (PyTorch's scalar /
    # tensor is a reciprocal then a product: two roundings).
    bm = torch.full_like(m, sfdt) / m
    Bd = torch.zeros((Bn, NX, NU), **kw)
    eye3 = torch.eye(3, **kw)
    for l in range(4):
        Bd[:, 6:9, 3 * l:3 * l + 3] = Bw[:, l]
        Bd[:, 9:12, 3 * l:3 * l + 3] = bm[:, None, None] * eye3
    col = torch.repeat_interleave(st, 3, dim=-1)  # (B, N, 12)
    Bt = Bd[:, None] * col[:, :, None, :]  # (B, N, 13, 12)
    A = torch.eye(NX, **kw).expand(Bn, NX, NX).clone()
    A[:, 0, 6] = dt * cy
    A[:, 0, 7] = dt * sy
    A[:, 1, 6] = -dt * sy
    A[:, 1, 7] = dt * cy
    A[:, 2, 8] = dt
    A[:, 3, 9] = dt
    A[:, 4, 10] = dt
    A[:, 5, 11] = dt
    A[:, 11, 12] = -g_dt

    # ---- cone data (scaled rows; per step the same, the bounds per step) ----
    gmu = -sf * mu
    one = torch.ones_like(mu)
    rows = torch.stack([
        torch.stack([sf * one, zero, gmu], -1),
        torch.stack([zero, sf * one, gmu], -1),
        torch.stack([zero, -sf * one, gmu], -1),
        torch.stack([-sf * one, zero, gmu], -1),
        torch.stack([zero, zero, sf * one], -1),
        torch.stack([zero, zero, -sf * one], -1)], -2)  # (B, 6, 3)
    G = torch.zeros((Bn, MC, NU), **kw)
    for l in range(4):
        G[:, 6 * l:6 * l + 6, 3 * l:3 * l + 3] = rows
    hb = torch.stack([zero, zero, zero, zero, fzmax, -fzmin], -1)  # (B, 6)
    stl = torch.repeat_interleave(st > 0.5, 6, dim=-1)  # (B, N, 24)
    h = torch.where(stl, hb.repeat(1, 4)[:, None, :],
                    torch.full((), SWING_ROW_RELAX, **kw))

    def gx(F):
        return torch.einsum("bri,bti->btr", G, F)

    def gty(z):
        return torch.einsum("bri,btr->bti", G, z)

    # ---- linear cost c' -----------------------------------------------------
    xi = xi0
    ys = []
    for t in range(N):
        xi = _mv(A, xi)
        ys.append(Lw * (xi - ref[:, t]))
    lam = torch.zeros_like(xi0)
    c = [None] * N
    for t in reversed(range(N)):
        lam_t = ys[t] + lam
        c[t] = 2.0 * _mtv(Bt[:, t], lam_t)
        lam = _mtv(A, lam_t)
    c = torch.stack(c, 1)  # (B, N, 12)
    cmax = torch.amax(torch.abs(c), dim=(1, 2))
    nu = 1.0 / torch.clamp(cmax, min=1e-12)
    c = c * nu[:, None, None]
    q_scale = 2.0 * nu
    r_diag = 2.0 * nu * (SIGMA_F * SIGMA_F * st_.alpha)
    obj_scale = 2.0
    h_scale = 1.0 + torch.amax(torch.abs(h), dim=(1, 2))
    qL = q_scale[:, None] * Lw  # (B, 13)

    def hvp(F):
        xi = torch.zeros_like(xi0)
        ys = []
        for t in range(N):
            xi = _mv(A, xi) + _mv(Bt[:, t], F[:, t])
            ys.append(qL * xi)
        lam = torch.zeros_like(xi0)
        out = [None] * N
        for t in reversed(range(N)):
            lam_t = ys[t] + lam
            out[t] = _mtv(Bt[:, t], lam_t) + r_diag[:, None] * F[:, t]
            lam = _mtv(A, lam_t)
        return torch.stack(out, 1)

    def residuals(F, s, z):
        rd = hvp(F) + c + gty(z)
        rp = gx(F) + s - h
        pr = torch.amax(torch.abs(rp), dim=(1, 2))
        dr = torch.amax(torch.abs(rd), dim=(1, 2))
        gap = torch.sum(s * z, dim=(1, 2))
        return rd, rp, pr, dr, gap

    # ---- start point --------------------------------------------------------
    if warm is None:
        s = torch.clamp(h, min=1.0)
        z = 1.0 / s
        F = torch.zeros((Bn, N, NU), **kw)
    else:
        Fw, sw, zw, stw = warm
        changed = torch.repeat_interleave(torch.abs(st - stw) > 0.5, 6,
                                          dim=-1)
        s_cold = torch.clamp(h, min=1.0)
        s_warm = torch.clamp(sw, min=1e-2)
        z_warm = torch.maximum(zw * nu[:, None, None],
                               torch.full_like(s_warm, 1e-2) / s_warm)
        s = torch.where(changed, s_cold, s_warm)
        z = torch.where(changed, 1.0 / s_cold, z_warm)
        same = (torch.abs(st - stw) < 0.5) & (st > 0.5)
        keep = torch.repeat_interleave(same, 3, dim=-1)
        F = torch.where(keep, Fw * (1.0 / sf), 0.0)
    bF = F
    best = torch.full((Bn,), 3.0e38, **kw)
    frozen = torch.zeros((Bn,), dtype=torch.bool, device=device)
    a_prev = torch.zeros((Bn,), **kw)
    inv_nmc = 1.0 / (N * MC)
    eye_u = torch.eye(NU, **kw)
    Qd = torch.diag_embed(qL)

    for _ in range(st_.iterations):
        rd, rp, pr, dr, gap = residuals(F, s, z)
        mu_avg = gap * inv_nmc
        merit = pr / h_scale + dr / obj_scale + mu_avg / obj_scale
        improve = merit < best
        if st_.track_best:
            bF = torch.where(improve[:, None, None], F, bF)
        best = torch.where(improve, merit, best)
        done = ((mu_avg < (100.0 * eps) * obj_scale)
                & (pr < (50.0 * eps) * h_scale)
                & (dr < (50.0 * eps) * obj_scale))
        om = 1.0 - a_prev
        sig = torch.clamp(om * om * om, min=0.03, max=st_.sigma_c)
        rc = (sig * mu_avg)[:, None, None]
        tv = (z * rp - (s * z - rc)) / s
        rhs = -rd - gty(tv)

        # Backward Riccati sweep.
        P = Qd
        p = torch.zeros_like(xi0)
        Ks, ks = [None] * N, [None] * N
        d = torch.clamp(z / s, max=d_max)
        for t in reversed(range(N)):
            B_t = Bt[:, t]
            Luu = (B_t.transpose(-1, -2) @ (P @ B_t)
                   + r_diag[:, None, None] * eye_u
                   + G.transpose(-1, -2) @ (d[:, t, :, None] * G))
            dmx = torch.amax(torch.diagonal(Luu, dim1=-2, dim2=-1), dim=-1)
            Luu = Luu + ((100.0 * eps) * dmx)[:, None, None] * eye_u
            Lf, Df = _ldl_factor(Luu)
            PA = P @ A
            Lux = B_t.transpose(-1, -2) @ PA
            K = -_ldl_solve(Lf, Df, Lux)
            lu = _mtv(B_t, p) - rhs[:, t]
            k = -_ldl_solve(Lf, Df, lu[..., None])[..., 0]
            p = _mtv(A, p) + _mtv(Lux, k)
            P = A.transpose(-1, -2) @ PA + Lux.transpose(-1, -2) @ K + Qd
            P = 0.5 * (P + P.transpose(-1, -2))
            Ks[t], ks[t] = K, k
        dxi = torch.zeros_like(xi0)
        dFs = []
        for t in range(N):
            du = _mv(Ks[t], dxi) + ks[t]
            dFs.append(du)
            dxi = _mv(A, dxi) + _mv(Bt[:, t], du)
        dF = torch.stack(dFs, 1)

        ds = -rp - gx(dF)
        dz = -((s * z - rc) + z * ds) / s
        ra = torch.where(ds < 0.0, -s / torch.where(ds < 0.0, ds, -1.0), big)
        rb = torch.where(dz < 0.0, -z / torch.where(dz < 0.0, dz, -1.0), big)
        amin = torch.amin(torch.minimum(ra, rb), dim=(1, 2))
        alpha_s = torch.clamp(st_.tau * amin, max=1.0)
        finite = torch.isfinite(dF).all(-1).all(-1)
        a = torch.where(done | frozen | ~finite, 0.0, alpha_s)
        ok = (a > 0.0)[:, None, None]
        a3 = a[:, None, None]
        # 0 * NaN = NaN: gate the update, never scale by 0.
        F = torch.where(ok, F + a3 * dF, F)
        s = torch.where(ok, torch.clamp(s + a3 * ds, min=tiny), s)
        z = torch.where(ok, torch.clamp(z + a3 * dz, min=tiny), z)
        frozen = frozen | done
        a_prev = a

    _, _, pr, dr, gap = residuals(F, s, z)
    gap = gap * inv_nmc
    merit_f = pr / h_scale + dr / obj_scale + gap / obj_scale
    use_final = (merit_f <= best) | (not st_.track_best)
    mk = col
    F_out = torch.where(use_final[:, None, None], F, bF) * sf * mk
    warm_out = (s, z * (1.0 / nu)[:, None, None], F * sf * mk)
    tol = st_.tol
    conv = ((pr < tol * h_scale) & (dr < tol * obj_scale)
            & (gap < tol * obj_scale))
    diag = torch.stack([conv.to(dtype), pr, dr, gap, nu, torch.zeros_like(nu)],
                       -1)
    return F_out, diag, warm_out


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------


def _unpack_block(mpc_p, N):
    """(25 + 17N, B) -> xi0 (B, 13), r (B, 4, 3), st (B, N, 4),
    ref (B, N, 13)."""
    Bn = mpc_p.shape[1]
    flat = mpc_p.t()
    return (flat[:, 0:NX], flat[:, NX:25].reshape(Bn, 4, 3),
            flat[:, 25:25 + 4 * N].reshape(Bn, N, 4),
            flat[:, 25 + 4 * N:].reshape(Bn, N, NX))


def solve_mpc_qp_riccati_packed(mpc_p, warm_p=None, *, n_steps: int,
                                dt: float, mass: float, inertia_diag,
                                mu: float, fz_min: float, fz_max: float,
                                state_weights, alpha: float = 1e-6,
                                iterations: int = 40, sigma_c: float = 0.5,
                                tau: float = 0.95, tol: float = 5e-4,
                                settings: MpcSettings = None):
    """The fused tick's MPC entry on the ``(25 + 17N, B)`` MPC precursor
    block the commander-pre kernel emits, with the robot constants as
    arguments. Yaw is ``xi0[2]``.

    Returns ``(F_p, diag_p)``: F_p (12N, B) horizon forces in Newtons (rows
    0:12 = the tick's GRFs), diag_p (6, B) rows [conv, pr, dr, gap, nu, 0].

    ``warm_p = (F_p_prev (12N, B), sz_p_prev (48N, B), sched_p_prev (4N,
    B))`` warm-starts the solve from the previous tick's solution (F in
    Newtons, [s | z] in original units, the schedule it was solved against;
    -1 for a cold first tick). Rows whose schedule bit changed reset cold.
    The return is then ``(F_p, diag_p, szf_p)`` with szf_p (60N, B) the [s |
    z | F] block of the FINAL iterate (F_p itself is the best-merit control
    output and is not recycled as the warm F).

    CUDA tensors: one launch of the CUDA kernel, counted in
    ``kernels.launch_counts["qct_mpc_riccati"]``; CPU tensors: the plain
    version. ``settings`` (an :class:`MpcSettings`) replaces the keyword
    arguments when given.
    """
    N = int(n_steps)
    if settings is None:
        settings = MpcSettings(
            n_steps=N, dt=dt, state_weights=state_weights, alpha=alpha,
            iterations=iterations, sigma_c=sigma_c, tau=tau, tol=tol,
            mass=mass, inertia_diag=inertia_diag, mu=mu, fz_min=fz_min,
            fz_max=fz_max)
    kb = mpc_block_size(N)
    if mpc_p.dim() != 2 or mpc_p.shape[0] != kb:
        raise ValueError(f"mpc_p: expected ({kb}, B) for N = {N}, got "
                         f"{tuple(mpc_p.shape)}")
    Bn = mpc_p.shape[1]
    if warm_p is not None:
        for name, a, k in zip(("F_prev", "sz_prev", "sched_prev"), warm_p,
                              (NU * N, 2 * MC * N, 4 * N)):
            if tuple(a.shape) != (k, Bn):
                raise ValueError(f"warm {name}: expected ({k}, {Bn}), got "
                                 f"{tuple(a.shape)}")
    if mpc_p.device.type != "cpu":
        out = kernels.mpc_riccati(
            mpc_p.float().contiguous(), None, None,
            None if warm_p is None else tuple(a.float().contiguous()
                                              for a in warm_p),
            settings.params(), N)
        return out if warm_p is not None else out[:2]

    return packed_plain(mpc_p, warm_p, settings)


def packed_plain(mpc_p, warm_p, settings: MpcSettings):
    """The plain version of the packed entry on any device (what
    :func:`solve_mpc_qp_riccati_packed` runs for CPU tensors; the chip smoke
    test calls it on the card to hold the kernel against it)."""
    N = settings.n_steps
    Bn = mpc_p.shape[1]
    kw = dict(dtype=torch.float32, device=mpc_p.device)
    xi0, r, st, ref = _unpack_block(mpc_p.float(), N)
    const = lambda v: torch.full((Bn,), v, **kw)  # noqa: E731
    Ib = torch.tensor(settings.inertia_diag, **kw).expand(Bn, 3)
    warm = None
    if warm_p is not None:
        Fw, sz, stw = (a.float().t() for a in warm_p)
        warm = (Fw.reshape(Bn, N, NU), sz[:, :MC * N].reshape(Bn, N, MC),
                sz[:, MC * N:].reshape(Bn, N, MC), stw.reshape(Bn, N, 4))
    F, diag, (s, z, Fwo) = _mpc_plain(
        xi0[:, 2], r, const(settings.mass), Ib, const(settings.mu),
        const(settings.fz_min), const(settings.fz_max), xi0, ref, st, warm,
        settings)
    F_p = F.reshape(Bn, N * NU).t().contiguous()
    diag_p = diag.t().contiguous()
    if warm_p is None:
        return F_p, diag_p
    szf = torch.cat([s.reshape(Bn, -1), z.reshape(Bn, -1),
                     Fwo.reshape(Bn, -1)], -1).t().contiguous()
    return F_p, diag_p, szf


def solve_mpc_qp_riccati(yaw, r_levers, mass, inertia_diag, mu, fz_min,
                         fz_max, xi0, xi_ref, stance_schedule, *,
                         n_steps: int, dt: float, state_weights,
                         alpha: float = 1e-6, iterations: int = 40,
                         sigma_c: float = 0.5, tau: float = 0.95,
                         tol: float = 5e-4):
    """The unpacked entry. Any batch B (no tile rule).

    Args:
      yaw: (B,), r_levers: (B, 4, 3) = feet_world - x_com, mass: (B,) or
      scalar, inertia_diag: (B, 3) or (3,), mu/fz_min/fz_max: scalars or
      (B,), xi0: (B, 13), xi_ref: (B, N, 13), stance_schedule: (B, N, 4).

    Returns (F (B, N, 12), IPMSolution-like diagnostics; z and s are zeros,
    as the TPU kernel's).
    """
    N = int(n_steps)
    device = xi0.device
    f32 = dict(dtype=torch.float32, device=device)
    Bn = xi0.shape[0]
    settings = MpcSettings(n_steps=N, dt=dt, state_weights=state_weights,
                           alpha=alpha, iterations=iterations,
                           sigma_c=sigma_c, tau=tau, tol=tol)

    def per_lane(v, tail=()):
        return torch.as_tensor(v, **f32).expand((Bn,) + tail)

    yaw_b = per_lane(yaw)
    r = torch.as_tensor(r_levers, **f32).reshape(Bn, 4, 3)
    phys = (per_lane(mass), per_lane(inertia_diag, (3,)), per_lane(mu),
            per_lane(fz_min), per_lane(fz_max))
    xi0_ = torch.as_tensor(xi0, **f32)
    ref = torch.as_tensor(xi_ref, **f32).reshape(Bn, N, NX)
    st = torch.as_tensor(stance_schedule, **f32).reshape(Bn, N, 4)
    if device.type != "cpu":
        block = torch.cat([xi0_, r.reshape(Bn, 12), st.reshape(Bn, 4 * N),
                           ref.reshape(Bn, NX * N)], -1).t().contiguous()
        phys_p = torch.cat([phys[0][:, None], phys[1], phys[2][:, None],
                            phys[3][:, None], phys[4][:, None]],
                           -1).t().contiguous()
        F_p, diag_p = kernels.mpc_riccati(
            block, yaw_b.contiguous(), phys_p, None, settings.params(), N)[:2]
        F = F_p.t().reshape(Bn, N, NU)
        diag = diag_p.t()
    else:
        F, diag, _ = _mpc_plain(yaw_b, r, *phys, xi0_, ref, st, None,
                                settings)
    sol = IPMSolution(
        x=F.reshape(Bn, N * NU), z=torch.zeros((Bn, N * MC), **f32),
        s=torch.zeros((Bn, N * MC), **f32),
        iterations=torch.as_tensor(iterations), gap=diag[:, 3],
        primal_residual=diag[:, 1], dual_residual=diag[:, 2],
        converged=diag[:, 0] > 0.5)
    return F, sol


def solve_mpc_fused(xi0, xi_ref, yaw, feet_world, x_com, stance_schedule,
                    horizon: int, dt, cfg: ControlConfig,
                    iterations: int = 40, mass=None, inertia_diag=None,
                    mu=None, state_weights=None, force_weight: float = 1e-6):
    """Drop-in analogue of mpc/horizon.solve_mpc running in K6. Any batch
    shape: instances are flattened (nothing is padded)."""
    kernels.refuse_grad("solve_mpc_fused", xi0, xi_ref, yaw, feet_world,
                        x_com, mass, inertia_diag, mu, state_weights)
    bal = cfg.balance
    r = feet_world - x_com[..., None, :]
    yaw = torch.as_tensor(yaw, dtype=xi0.dtype, device=xi0.device)
    batch = tuple(torch.broadcast_shapes(
        xi0.shape[:-1], xi_ref.shape[:-2], yaw.shape, r.shape[:-2],
        stance_schedule.shape[:-2]))
    Bn = 1
    for d in batch:
        Bn *= int(d)
    N = int(horizon)

    def flat(a, tail):
        return a.expand(batch + tail).reshape((Bn,) + tail)

    def flat_param(v, tail=()):
        v = torch.as_tensor(v, dtype=torch.float32, device=xi0.device)
        if v.dim() == 0 or tuple(v.shape) == tail:
            return v
        return flat(v, tail)

    F, sol = solve_mpc_qp_riccati(
        flat(yaw, ()), flat(r, (4, 3)),
        flat_param(bal.mass if mass is None else mass),
        flat_param(bal.inertia_diag if inertia_diag is None else inertia_diag,
                   (3,)),
        flat_param(bal.mu if mu is None else mu), bal.fz_min, bal.fz_max,
        flat(xi0, (NX,)), flat(xi_ref, (N, NX)),
        flat(stance_schedule.to(torch.float32), (N, 4)),
        n_steps=N, dt=float(dt),
        state_weights=state_weights,
        alpha=float(force_weight), iterations=iterations)
    if len(batch) == 1:
        return F, sol

    def unflat(a, tail):
        return a.reshape(batch + tail)

    return unflat(F, (N, NU)), IPMSolution(
        x=unflat(sol.x, (N * NU,)), z=unflat(sol.z, (N * MC,)),
        s=unflat(sol.s, (N * MC,)), iterations=sol.iterations,
        gap=unflat(sol.gap, ()),
        primal_residual=unflat(sol.primal_residual, ()),
        dual_residual=unflat(sol.dual_residual, ()),
        converged=unflat(sol.converged, ()))
