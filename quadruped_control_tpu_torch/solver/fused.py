"""Fused GRF-QP solve: assembly + equilibration + barrier IPM + certified
active-set polish (+ proximal restarts) in ONE CUDA kernel launch.

Port of ``quadruped_control_tpu/solver/pallas_fused.py``. The kernel takes
the ~26 f32/instance of RAW scenario state the reference controller starts
from (balance_controller.cpp:98-161):

  - ``r``  (12): stance-masked world-frame CoM->foot vectors R @ p_i,
  - ``b``   (6): the SRB Newton-Euler right-hand side,
  - ``stance`` (4), ``mu`` (1), ``fz_min``/``fz_max`` (2),

and rebuilds everything per instance, never writing the dense problem to
device memory:

  1. **Assembly** — Q = 2(A^T S A + W) in closed form; the friction-cone
     rows are carried as per-row sparse (col, value) lists (<= 2 nonzeros at
     static positions).
  2. **Equilibration** — Jacobi / row / cost scaling (solver/ipm.py
     ``equilibrate``), which preserves the cone rows' sparsity.
  3. **Barrier loop** — Mehrotra predictor-corrector with an unrolled 12x12
     Cholesky + one refinement step, every G product through the sparse rows.
  4. **Polish** — certified active-set polish: packed 36x36 quasidefinite
     LDL^T, iterative refinement with float-float (Dekker) residuals,
     add-most-violated / drop-most-negative swap, strict certificate.
  5. **Proximal restarts** (optional) and the **map-back + diagnostics** in
     original units.

Two kernels live here, each with three things beside it (csrc/ holds the
CUDA C++): the wrapper that launches it and counts the launch
(``solve_grf_qp_fused_packed`` -> ``qct_fused_solve``, K1;
``assemble_qp_fused_debug`` -> ``qct_assemble``, K2), and its PLAIN PYTORCH
VERSION (``_fused_plain``, ``_assembly_plain``): the same algorithm on lists
of (B,) tensors, one Python statement per kernel statement, so the rounding
order, the NaN poison and the tie rules follow the kernel. A wrapper takes
the plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches the kernel or raises.

Layout. The kernels map one QP to one CUDA thread and read structure-of-
arrays tensors ``(k, B)`` (neighbouring threads, neighbouring addresses);
the ragged edge is masked in the kernel, so any B is accepted. The ``(B,
k)`` public functions transpose at the edge. ``barrier_rows`` and
``polish_rows`` (tile heights of the TPU kernel) are accepted for signature
parity and ignored. ``rows`` and ``tail_rows`` set the sizes of the
compacted re-solve slices and nothing else: the JAX package pads its batch
to a multiple of ``rows * 128`` and sizes each slice from that padded batch
(:func:`two_phase_tail_size`, :func:`prox_slice_size`,
:func:`qp_tail_size`); the port pads nothing and caps each slice at the real
B. In the stable worst-first order, padded copies of instance 0 sort after
every real unconverged instance, and a merge takes only flags that
improved, so the real instances whose flag can change are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import BalanceConfig
from quadruped_control_tpu_torch.math.rotations import skew
from quadruped_control_tpu_torch.ops.dynamics import (
    SWING_ROW_RELAX,
    assemble_qp,
    cone_constraints,
    pd_accelerations,
)
from quadruped_control_tpu_torch.solver.ipm import IPMSolution, solve_qp_prox

N = 12
M = 24
NK = N + M  # full KKT dimension (36)
_POLISH_SWEEPS_FUSED = 8
_POLISH_REFINE = 4
_N_DIAG = 6  # cert, conv, pr, dr, gap, reserved
SUB = 8      # the TPU kernels' default tile height (``rows``)
LANE = 128
TILE = SUB * LANE  # the dense IPM kernels' grid step

# Friction-cone row sparsity (ops/dynamics.py friction_cone_rows, one-sided
# form): per leg, row t has nonzeros in local columns _ROW_COLS[t] with signs
# _ROW_SIGN[t]; the z-column entry of rows 0-3 is -mu (handled separately).
_ROW_COLS = ((0, 2), (1, 2), (1, 2), (0, 2), (2,), (2,))
_ROW_SIGN = ((1.0, None), (1.0, None), (-1.0, None), (-1.0, None),
             (1.0,), (-1.0,))

_EPS = 1.1920929e-07   # float32 machine epsilon
_TINY = 1.1754944e-38  # float32 smallest normal
_BIG = 3.0e38
_NAN = float("nan")


class FusedSchedule(NamedTuple):
    """Every runtime knob of the fused kernel (runtime arguments of the CUDA
    kernel too: one compiled kernel serves every schedule)."""

    s_diag: tuple
    w_diag: float
    swing_relax: float = SWING_ROW_RELAX
    iterations: int = 20
    tau: float = 0.995
    tol: float = 3e-5
    polish: bool = True
    polish_sweeps: int = _POLISH_SWEEPS_FUSED
    polish_refine: int = _POLISH_REFINE
    polish_multi_swap: bool = False
    prox_steps: int = 0
    prox_iterations: int = 10
    prox_rho: float = 1e-2
    prox_sweeps: Optional[int] = None
    prox_cold: bool = False
    ff_refine: bool = True


# ---------------------------------------------------------------------------
# Plain PyTorch version: elementwise helpers (NaN-propagating like
# jnp.maximum / jnp.minimum; CUDA's fmaxf/fminf are NOT — the kernel has its
# own helpers).
# ---------------------------------------------------------------------------

def _fmax(a, b):
    if isinstance(b, float):
        return torch.clamp(a, min=b)
    return torch.maximum(a, b)


def _fmin(a, b):
    if isinstance(b, float):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b)


def _rsqrt(x):
    # Two correctly-rounded IEEE operations (the kernel: 1.0f / sqrtf(x)).
    return 1.0 / torch.sqrt(x)


def _two_sum(a, b):
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _two_prod(a, b):
    """Dekker error-free product on f32 tensors (split at 2^12 + 1)."""
    p = a * b
    ca = 4097.0 * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = 4097.0 * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _ff_linear(terms):
    """Compensated sum of [(coeff, vec), ...] products: sum_i c_i * v_i.

    Every product is error-free split, accumulation is two_sum-chained; the
    result captures cancellation between O(1) terms down to ~eps of the true
    (small) value."""
    acc = torch.zeros_like(terms[0][1])
    comp = torch.zeros_like(acc)
    for cf, v in terms:
        p, e1 = _two_prod(cf, v)
        acc, e2 = _two_sum(acc, p)
        comp = comp + e1 + e2
    return acc + comp


def _skew_quad(rl, rlp, d):
    """3x3 block skew(rl)^T diag(d) skew(rlp) as a dict {(a,b): tensor}."""
    x, y, z = rl
    xp, yp, zp = rlp
    d1, d2, d3 = d
    return {
        (0, 0): d2 * z * zp + d3 * y * yp,
        (0, 1): -d3 * y * xp,
        (0, 2): -d2 * z * xp,
        (1, 0): -d3 * x * yp,
        (1, 1): d1 * z * zp + d3 * x * xp,
        (1, 2): -d1 * z * yp,
        (2, 0): -d2 * x * zp,
        (2, 1): -d1 * y * zp,
        (2, 2): d1 * y * yp + d2 * x * xp,
    }


_f32 = kernels._f32  # a Python float rounded to float32: what the kernel gets


def _assemble(r, b, st, mu, fzmin, fzmax, s_diag, w_diag, swing_relax):
    """Closed-form QP assembly on (B,) tensors.

    Implements exactly ops/dynamics.py::{srb_dynamics (A side), assemble_qp,
    cone_constraints} given the precomputed, stance-masked world CoM->foot
    vectors ``r`` and SRB rhs ``b`` (balance_controller.cpp:152-153,
    274-330).

    Returns:
      Qu: 2D upper list, Qu[i][j] for i <= j.
      c:  list of N tensors.
      Grow: list of M rows; each row is a list of (local_col, tensor).
      h:  list of M tensors.
    """
    sl = [_f32(2.0 * s_diag[k]) for k in range(3)]      # 2*S_lin baked in
    sa = [_f32(s_diag[3 + k]) for k in range(3)]        # S_ang (quad has 2x)
    w2 = _f32(2.0 * w_diag)
    one = torch.ones_like(mu)

    # Q upper triangle: block (l, l') for l <= l'.
    Qu = [[None] * N for _ in range(N)]
    for l in range(4):
        for lp in range(l, 4):
            quad = _skew_quad(r[l], r[lp], sa)
            mm = st[l] * st[lp]
            for a in range(3):
                for bcol in range(3):
                    i, j = 3 * l + a, 3 * lp + bcol
                    if i > j:
                        continue
                    v = 2.0 * quad[(a, bcol)]
                    if a == bcol:
                        v = v + mm * sl[a]
                        if l == lp:
                            v = v + w2
                    Qu[i][j] = v

    # c = -2 A^T S b.
    bl, ba = b[:3], b[3:]
    c = [None] * N
    for l in range(4):
        x, y, z = r[l]
        c[3 * l + 0] = -(st[l] * sl[0] * bl[0]
                         + 2.0 * (sa[1] * z * ba[1] - sa[2] * y * ba[2]))
        c[3 * l + 1] = -(st[l] * sl[1] * bl[1]
                         + 2.0 * (-sa[0] * z * ba[0] + sa[2] * x * ba[2]))
        c[3 * l + 2] = -(st[l] * sl[2] * bl[2]
                         + 2.0 * (sa[0] * y * ba[0] - sa[1] * x * ba[1]))

    # Sparse cone rows + bounds.
    relax = _f32(swing_relax)
    zero = torch.zeros_like(mu)
    Grow = []
    h = []
    for l in range(4):
        for t in range(6):
            entries = []
            for k, col in enumerate(_ROW_COLS[t]):
                if col == 2 and t < 4:
                    entries.append((2, -mu))
                else:
                    entries.append((col, _ROW_SIGN[t][k] * one))
            Grow.append(entries)
        hb = [zero, zero, zero, zero, fzmax, -fzmin]
        for t in range(6):
            h.append(torch.where(st[l] > 0.5, hb[t], relax))
    return Qu, c, Grow, h


def _equilibrate_tiles(Qu, c, Grow, h):
    """Per-instance port of solver/ipm.py::equilibrate (sparsity-preserving)."""
    Dv = [_rsqrt(_fmax(Qu[j][j], 1e-12)) for j in range(N)]
    Qs = [[None] * N for _ in range(N)]
    for i in range(N):
        for j in range(i, N):
            Qs[i][j] = Qu[i][j] * Dv[i] * Dv[j]
    cs = [c[i] * Dv[i] for i in range(N)]

    Gs, Er, hs = [], [], []
    for r in range(M):
        leg = r // 6
        scaled = [(k, v * Dv[3 * leg + k]) for k, v in Grow[r]]
        rn = torch.abs(scaled[0][1])
        for _, v in scaled[1:]:
            rn = _fmax(rn, torch.abs(v))
        er = 1.0 / _fmax(rn, 1e-12)
        Gs.append([(k, v * er) for k, v in scaled])
        Er.append(er)
        hs.append(h[r] * er)

    cmax = torch.abs(cs[0])
    for i in range(1, N):
        cmax = _fmax(cmax, torch.abs(cs[i]))
    nu = 1.0 / _fmax(cmax, 1e-12)
    for i in range(N):
        cs[i] = cs[i] * nu
        for j in range(i, N):
            Qs[i][j] = Qs[i][j] * nu
    return Qs, cs, Gs, hs, Dv, Er, nu


def _sym(Qu, i, j):
    return Qu[i][j] if i <= j else Qu[j][i]


def _col_rows():
    """col (0..2) -> list of leg-local row indices with a nonzero there."""
    out = {0: [], 1: [], 2: []}
    for t in range(6):
        for col in _ROW_COLS[t]:
            out[col].append(t)
    return out


_COL_ROWS = _col_rows()


def _gx(Gs, xv, r):
    """(G x)_r via the sparse row."""
    leg = r // 6
    acc = None
    for k, g in Gs[r]:
        term = g * xv[3 * leg + k]
        acc = term if acc is None else acc + term
    return acc


def _gty(Gs, zv, i):
    """(G^T z)_i via the sparse columns."""
    leg, a = i // 3, i % 3
    acc = None
    for t in _COL_ROWS[a]:
        r = 6 * leg + t
        g = dict(Gs[r])[a]
        term = g * zv[r]
        acc = term if acc is None else acc + term
    return acc


def _all_finite(vs):
    f = torch.isfinite(vs[0])
    for v in vs[1:]:
        f = f & torch.isfinite(v)
    return f


def _barrier(Qs, cs, Gs, hs, *, iterations: int, tau: float, init=None):
    """Sparse-cone Mehrotra loop on the equilibrated problem.

    Cold start x = 0, s = max(h, 1), z = 1/s unless ``init`` gives a warm
    (x, s, z) triple of lists in EQUILIBRATED units (the caller does the
    interior shift / stale-row resets). Returns the best iterate by scaled
    KKT merit; a lane whose step went non-finite is poisoned (0 * NaN) and
    keeps its best iterate."""
    eps = _EPS
    d_max = _f32(1.0 / eps)

    one = torch.ones_like(cs[0])
    if init is None:
        x = [torch.zeros_like(cs[0]) for _ in range(N)]
        s = [_fmax(hs[r], 1.0) for r in range(M)]
        z = [one / s[r] for r in range(M)]
    else:
        x, s, z = (list(init[0]), list(init[1]), list(init[2]))

    obj_scale = one
    for i in range(N):
        obj_scale = _fmax(obj_scale, 1.0 + torch.abs(cs[i]))
    h_scale = one
    for r in range(M):
        h_scale = _fmax(h_scale, 1.0 + torch.abs(hs[r]))
    freeze_gap = _f32(100.0 * eps) * obj_scale
    freeze_pr = _f32(50.0 * eps) * h_scale
    freeze_dr = _f32(50.0 * eps) * obj_scale

    def chol_solve(Lmat, rhs):
        y = [None] * N
        for i in range(N):
            v = rhs[i]
            for k in range(i):
                v = v - Lmat[i][k] * y[k]
            y[i] = v * Lmat[i][i]  # diag stores 1/L_ii
        u = [None] * N
        for i in reversed(range(N)):
            v = y[i]
            for k in range(i + 1, N):
                v = v - Lmat[k][i] * u[k]
            u[i] = v * Lmat[i][i]
        return u

    def body(carry):
        x, s, z, best = carry

        Gx = [_gx(Gs, x, r) for r in range(M)]
        r_prim = [Gx[r] + s[r] - hs[r] for r in range(M)]

        r_dual = [None] * N
        for i in range(N):
            v = cs[i]
            for j in range(N):
                v = v + _sym(Qs, i, j) * x[j]
            r_dual[i] = v + _gty(Gs, z, i)

        d = [_fmin(z[r] / s[r], d_max) for r in range(M)]

        # M = Q + G^T D G: the cone term is leg-block-diagonal.
        Mm = [[None] * N for _ in range(N)]
        for i in range(N):
            for j in range(i, N):
                Mm[i][j] = Qs[i][j]
        for leg in range(4):
            for t in range(6):
                r = 6 * leg + t
                row = Gs[r]
                u = [(k, d[r] * g) for k, g in row]
                for a, ua in u:
                    for b, gb in row:
                        if b < a:
                            continue
                        i, j = 3 * leg + a, 3 * leg + b
                        Mm[i][j] = Mm[i][j] + ua * gb
        diag_max = Mm[0][0]
        for i in range(1, N):
            diag_max = _fmax(diag_max, Mm[i][i])
        delta = _f32(100.0 * eps) * diag_max
        for i in range(N):
            Mm[i][i] = Mm[i][i] + delta

        Lm = [[None] * N for _ in range(N)]
        for j in range(N):
            dd = Mm[j][j]
            for k in range(j):
                dd = dd - Lm[j][k] * Lm[j][k]
            dd = torch.where(dd > 0.0, dd, _NAN)
            inv = _rsqrt(dd)
            Lm[j][j] = inv
            for i in range(j + 1, N):
                v = Mm[j][i]
                for k in range(j):
                    v = v - Lm[i][k] * Lm[j][k]
                Lm[i][j] = v * inv

        def kkt_solve(rhs):
            u = chol_solve(Lm, rhs)
            resid = [None] * N
            for i in range(N):
                v = rhs[i]
                for j in range(N):
                    mij = Mm[i][j] if j >= i else Mm[j][i]
                    if j == i:
                        mij = mij - delta
                    v = v - mij * u[j]
                resid[i] = v
            corr = chol_solve(Lm, resid)
            return [u[i] + corr[i] for i in range(N)]

        mu = s[0] * z[0]
        for r in range(1, M):
            mu = mu + s[r] * z[r]
        mu = mu * (1.0 / M)

        def newton(rc):
            t = [(z[r] * r_prim[r] - rc[r]) / s[r] for r in range(M)]
            rhs = [-r_dual[i] - _gty(Gs, t, i) for i in range(N)]
            dx = kkt_solve(rhs)
            Gdx = [_gx(Gs, dx, r) for r in range(M)]
            ds = [-r_prim[r] - Gdx[r] for r in range(M)]
            dz = [-(rc[r] + z[r] * ds[r]) / s[r] for r in range(M)]
            return dx, ds, dz

        def max_step(v, dv, t_frac):
            ratio = torch.full_like(v[0], _BIG)
            for r in range(M):
                neg = dv[r] < 0.0
                rr = torch.where(neg, -v[r] / torch.where(neg, dv[r], -1.0),
                                 _BIG)
                ratio = _fmin(ratio, rr)
            return _fmin(t_frac * ratio, 1.0)

        rc_aff = [s[r] * z[r] for r in range(M)]
        dx_a, ds_a, dz_a = newton(rc_aff)
        a_aff = _fmin(max_step(s, ds_a, 1.0), max_step(z, dz_a, 1.0))

        mu_aff = (s[0] + a_aff * ds_a[0]) * (z[0] + a_aff * dz_a[0])
        for r in range(1, M):
            mu_aff = mu_aff + (s[r] + a_aff * ds_a[r]) * (z[r] + a_aff * dz_a[r])
        mu_aff = mu_aff * (1.0 / M)
        ratio = mu_aff / _fmax(mu, 1e-30)
        sigma_mu = ratio * ratio * ratio * mu

        rc = [s[r] * z[r] + ds_a[r] * dz_a[r] - sigma_mu for r in range(M)]
        dx, ds, dz = newton(rc)
        alpha = _fmin(max_step(s, ds, tau), max_step(z, dz, tau))

        pr_max = torch.abs(r_prim[0])
        dr_max = torch.abs(r_dual[0])
        for r in range(1, M):
            pr_max = _fmax(pr_max, torch.abs(r_prim[r]))
        for i in range(1, N):
            dr_max = _fmax(dr_max, torch.abs(r_dual[i]))
        done = (mu < freeze_gap) & (pr_max < freeze_pr) & (dr_max < freeze_dr)

        bx, bs, bz, bmerit = best
        merit = pr_max / h_scale + dr_max / obj_scale + mu / obj_scale
        improve = (merit < bmerit) & _all_finite(x)
        bx = [torch.where(improve, x[i], bx[i]) for i in range(N)]
        bs = [torch.where(improve, s[r], bs[r]) for r in range(M)]
        bz = [torch.where(improve, z[r], bz[r]) for r in range(M)]
        bmerit = torch.where(improve, merit, bmerit)

        finite = _all_finite(dx) & _all_finite(ds) & _all_finite(dz)

        a = torch.where(done | ~finite, 0.0, alpha)
        x_new = [x[i] + a * dx[i] for i in range(N)]
        s_new = [_fmax(s[r] + a * ds[r], _TINY) for r in range(M)]
        z_new = [_fmax(z[r] + a * dz[r], _TINY) for r in range(M)]
        return x_new, s_new, z_new, (bx, bs, bz, bmerit)

    best0 = (
        [torch.zeros_like(cs[0]) for _ in range(N)],
        [s[r] for r in range(M)],
        [z[r] for r in range(M)],
        torch.full_like(cs[0], float("inf")),
    )
    carry = (x, s, z, best0)
    for _ in range(iterations):
        carry = body(carry)
    bx, bs, bz, _ = carry[3]
    return bx, bs, bz


def _tri(i, j):
    """Packed lower-triangle index."""
    return i * (i + 1) // 2 + j


_NK_TRI = NK * (NK + 1) // 2  # 666 words: half the dense NK^2 scratch


def _polish(Qs, cs, Gs, hs, x0, s0, z0, *, sweeps: int, refine: int,
            a0=None, multi_swap: bool = False, ff_refine: bool = True):
    """Certified active-set polish on the equilibrated problem. Returns
    (x, s, z, cert) in equilibrated units.

    ``a0``: optional initial active-set guess (M tensors of 0/1). Default is
    the barrier heuristic z0 > s0. Control streams pass the PREVIOUS tick's
    certified active set instead (the warm carry) — qpOASES's working-set
    hotstart (balance_controller.cpp:193-195), applied to the polish stage.

    The quasidefinite KKT is stored as a PACKED LOWER TRIANGLE (666 words)
    and the LDL^T factor overwrites it in place — legal because the
    iterative-refinement residuals are rebuilt from the persistent Qs/Gs,
    never from K."""
    eps = _EPS
    reg = 1e-4
    big = _BIG

    one = torch.ones_like(cs[0])
    obj_scale = one
    for i in range(N):
        obj_scale = _fmax(obj_scale, 1.0 + torch.abs(cs[i]))
    h_scale = one
    for r in range(M):
        h_scale = _fmax(h_scale, 1.0 + torch.abs(hs[r]))
    zmax = z0[0]
    for r in range(1, M):
        zmax = _fmax(zmax, z0[r])
    cert_dr = _f32(30.0 * eps) * obj_scale
    feas_tol = max(_f32(1e-6), _f32(30.0 * eps)) * h_scale
    z_tol = max(_f32(1e-6), _f32(30.0 * eps)) * (1.0 + zmax)

    zero = torch.zeros_like(cs[0])
    Ksc = [None] * _NK_TRI
    Dsc = [None] * NK
    usc = [None] * NK

    def build_K(a):
        """Write only the lower triangle (row-major packed)."""
        for i in range(N):
            for j in range(i + 1):
                Ksc[_tri(i, j)] = _sym(Qs, i, j)
        for r in range(M):
            leg = r // 6
            vals = dict(Gs[r])
            row = N + r
            for i in range(N):
                k = i - 3 * leg
                Ksc[_tri(row, i)] = a[r] * vals[k] if k in vals else zero
            for rp in range(r):
                Ksc[_tri(row, N + rp)] = zero
            Ksc[_tri(row, row)] = -(reg * a[r] + (1.0 - a[r]))

    def ldl_factor():
        """In-place packed LDL^T: each K[i,j] is read exactly once (at its
        own elimination step), so L can overwrite K with no second copy."""
        for j in range(NK):
            bj = _tri(j, 0)
            dd = Ksc[bj + j]
            for k in range(j):
                dd = dd - Ksc[bj + k] * Ksc[bj + k] * Dsc[k]
            dd = torch.where(torch.abs(dd) > 1e-30, dd, _NAN)
            Dsc[j] = dd
            dinv = 1.0 / dd
            for i in range(j + 1, NK):
                bi = _tri(i, 0)
                v = Ksc[bi + j]
                for k in range(j):
                    v = v - Ksc[bi + k] * Dsc[k] * Ksc[bj + k]
                Ksc[bi + j] = v * dinv

    def ldl_solve_inplace():
        for i in range(NK):
            bi = _tri(i, 0)
            v = usc[i]
            for k in range(i):
                v = v - Ksc[bi + k] * usc[k]
            usc[i] = v
        for i in reversed(range(NK)):
            v = usc[i] / Dsc[i]
            for k in range(i + 1, NK):
                v = v - Ksc[_tri(k, i)] * usc[k]
            usc[i] = v

    def true_matvec_residual(a, xp, zp, rhs1, rhs2):
        r1 = [None] * N
        for i in range(N):
            v = rhs1[i]
            for j in range(N):
                v = v - _sym(Qs, i, j) * xp[j]
            leg, col = i // 3, i % 3
            for t in _COL_ROWS[col]:
                r = 6 * leg + t
                g = dict(Gs[r])[col]
                v = v - a[r] * g * zp[r]
            r1[i] = v
        r2 = [None] * M
        for r in range(M):
            v = rhs2[r] - (1.0 - a[r]) * zp[r] - a[r] * _gx(Gs, xp, r)
            r2[r] = v
        return r1, r2

    def ff_dual_residual(a, xp, zp, rhs1):
        r1 = [None] * N
        for i in range(N):
            terms = [(-1.0 * _sym(Qs, i, j), xp[j]) for j in range(N)]
            leg, col = i // 3, i % 3
            for t in _COL_ROWS[col]:
                r = 6 * leg + t
                g = dict(Gs[r])[col]
                terms.append((-(a[r] * g), zp[r]))
            terms.append((one, rhs1[i]))
            r1[i] = _ff_linear(terms)
        return r1

    def ff_primal_residual(a, xp, zp, rhs2):
        """Compensated r2 = rhs2 - (1-a) z - a G x: with plain-f32
        residuals, iterative refinement stalls at eps*cond(K) dual error for
        the degenerate cond ~1e6 4-stance family; error-free residuals
        restore the backward-stable ~eps floor (mixed-precision IR)."""
        r2 = [None] * M
        for r in range(M):
            leg = r // 6
            terms = [(one, rhs2[r]), (-(1.0 - a[r]), zp[r])]
            for k, g in Gs[r]:
                terms.append((-(a[r] * g), xp[3 * leg + k]))
            r2[r] = _ff_linear(terms)
        return r2

    # The slack stays plain f32: its feas_tol is 1e-6*h_scale, ~10x above
    # f32 Gx noise; the binding criterion is the 30-eps DUAL residual.

    def sweep_body(carry):
        a, bx, bz, bs, cert = carry
        build_K(a)
        ldl_factor()
        rhs1 = [-cs[i] for i in range(N)]
        rhs2 = [a[r] * hs[r] for r in range(M)]
        for i in range(N):
            usc[i] = rhs1[i]
        for r in range(M):
            usc[N + r] = rhs2[r]
        ldl_solve_inplace()
        xp = [usc[i] for i in range(N)]
        zp = [usc[N + r] for r in range(M)]

        for k in range(refine):
            # Float-float residuals on all refinement passes but the first:
            # the early pass shrinks the error by ~1e3x, where plain f32
            # residuals are accurate enough; the final passes need
            # error-free residuals to reach the ~30 eps certification floor
            # at cond ~1e6. ff_refine=False: the prox-internal regularized
            # polish, which accepts on the LOOSE criterion.
            if not ff_refine or (k == 0 and refine > 1):
                r1, r2 = true_matvec_residual(a, xp, zp, rhs1, rhs2)
            else:
                r1 = ff_dual_residual(a, xp, zp, rhs1)
                r2 = ff_primal_residual(a, xp, zp, rhs2)
            for i in range(N):
                usc[i] = r1[i]
            for r in range(M):
                usc[N + r] = r2[r]
            ldl_solve_inplace()
            xp = [xp[i] + usc[i] for i in range(N)]
            zp = [zp[r] + usc[N + r] for r in range(M)]

        r1 = ff_dual_residual(a, xp, zp, rhs1)
        dr_max = torch.abs(r1[0])
        for i in range(1, N):
            dr_max = _fmax(dr_max, torch.abs(r1[i]))
        slack = [hs[r] - _gx(Gs, xp, r) for r in range(M)]
        slack_min = slack[0]
        z_signed = zp[0] * a[0]
        for r in range(1, M):
            slack_min = _fmin(slack_min, slack[r])
            z_signed = _fmin(z_signed, zp[r] * a[r])
        finite = _all_finite(xp) & _all_finite(zp)
        ok = (
            finite
            & (slack_min > -feas_tol)
            & (z_signed > -z_tol)
            & (dr_max < cert_dr)
        )

        take = ok & (cert < 0.5)
        bx = [torch.where(take, xp[i], bx[i]) for i in range(N)]
        bz = [torch.where(take, _fmax(a[r] * zp[r], 0.0), bz[r])
              for r in range(M)]
        bs = [torch.where(take, _fmax(slack[r], 0.0), bs[r])
              for r in range(M)]
        cert = _fmax(cert, ok.to(cert.dtype))

        if multi_swap:
            # Experimental probe, default off: swap EVERY violated/negative
            # row at once instead of one per sweep.
            a_new = []
            for r in range(M):
                add_r = (-slack[r] > feas_tol) & ~(a[r] > 0.5)
                drop_r = (a[r] > 0.5) & (zp[r] < -z_tol)
                a_new.append(torch.where(add_r, 1.0,
                                         torch.where(drop_r, 0.0, a[r])))
        else:
            # Single swap: add the most violated inactive row, else drop the
            # most negative multiplier; strict >/< keep the LOWEST index on
            # ties.
            viol_best = torch.full_like(cs[0], -big)
            viol_idx = torch.zeros_like(cs[0])
            negz_best = torch.full_like(cs[0], big)
            negz_idx = torch.zeros_like(cs[0])
            for r in range(M):
                viol_r = torch.where(a[r] > 0.5, -big, -slack[r])
                upd = viol_r > viol_best
                viol_best = torch.where(upd, viol_r, viol_best)
                viol_idx = torch.where(upd, float(r), viol_idx)
                nz_r = torch.where(a[r] > 0.5, zp[r], big)
                updn = nz_r < negz_best
                negz_best = torch.where(updn, nz_r, negz_best)
                negz_idx = torch.where(updn, float(r), negz_idx)
            do_add = viol_best > feas_tol
            do_drop = (~do_add) & (negz_best < -z_tol)
            a_new = list(a)
            for r in range(M):
                a_new[r] = torch.where(
                    do_add & (viol_idx == float(r)), 1.0,
                    torch.where(do_drop & (negz_idx == float(r)), 0.0, a[r]))
        a = [torch.where(cert > 0.5, a[r], a_new[r]) for r in range(M)]
        return a, bx, bz, bs, cert

    if a0 is None:
        a0 = [(z0[r] > s0[r]).to(cs[0].dtype) for r in range(M)]
    carry = (a0, x0, z0, s0, torch.zeros_like(x0[0]))
    for _ in range(sweeps):
        carry = sweep_body(carry)
    _, bx, bz, bs, cert = carry
    return bx, bs, bz, cert


def _kkt_flags(Q, c, G, h, x, s, z, tol):
    """(conv, pr, dr, gap) of the loose KKT criterion for the problem
    (Q upper lists, c, sparse rows G, h) at (x, s, z) in ITS units."""
    gap = s[0] * z[0]
    pr = torch.abs(_gx(G, x, 0) + s[0] - h[0])
    for rr in range(1, M):
        gap = gap + s[rr] * z[rr]
        pr = _fmax(pr, torch.abs(_gx(G, x, rr) + s[rr] - h[rr]))
    gap = torch.abs(gap) * (1.0 / M)
    dr = None
    for i in range(N):
        v = c[i]
        for j in range(N):
            v = v + _sym(Q, i, j) * x[j]
        leg, col = i // 3, i % 3
        for t in _COL_ROWS[col]:
            rr = 6 * leg + t
            g = dict(G[rr])[col]
            v = v + g * z[rr]
        va = torch.abs(v)
        dr = va if dr is None else _fmax(dr, va)
    cmax = torch.abs(c[0])
    hmax = torch.abs(h[0])
    for i in range(1, N):
        cmax = _fmax(cmax, torch.abs(c[i]))
    for rr in range(1, M):
        hmax = _fmax(hmax, torch.abs(h[rr]))
    scale = 1.0 + cmax
    tolf = _f32(tol)
    conv = ((pr < tolf * (1.0 + hmax)) & (dr < tolf * scale)
            & (gap < tolf * scale))
    return conv, pr, dr, gap


def _loose_conv(Qu, c, Grow, h, Dv, Er, nu, x, s, z, tol):
    """The loose original-units KKT criterion for an EQUILIBRATED candidate
    (x, s, z) — gates prox-restart acceptance."""
    inv_nu = 1.0 / nu
    xo = [x[i] * Dv[i] for i in range(N)]
    zo = [z[r] * Er[r] * inv_nu for r in range(M)]
    so = [s[r] / Er[r] for r in range(M)]
    return _kkt_flags(Qu, c, Grow, h, xo, so, zo, tol)[0]


def _fused_plain(r_in, b_in, st_in, mu_in, fzmin_in, fzmax_in, warm,
                 p: FusedSchedule):
    """Plain PyTorch version of the fused kernel (K1) on (k, B) tensors.

    Modes, as the kernel's: full (barrier + polish); barrier-only
    (``polish=False``); polish-only (``warm = (x, s, z)`` in ORIGINAL units,
    ``iterations == 0``); WARM-STARTED barrier (``warm = (x, s, z,
    st_prev)``, ``iterations > 0``): the previous solution seeds the barrier
    after an interior shift of 1e-2, the 6 cone rows of any leg whose stance
    flag differs from ``st_prev`` are reset to the cold start, and the
    previous active set (original-units z > s) seeds the polish, -1 marking
    reset rows that fall back to the barrier heuristic. Zeros for (x, s, z)
    with st_prev = -1 reproduce the cold start BITWISE.

    ``prox_steps > 0`` (needs polish): proximal restarts for the degenerate
    4-stance family whose active set defeats the single-swap search. Each
    step solves min 1/2 x^T(Q + rho I)x + (c - rho x_k)^T x with rho =
    prox_rho * mean(diag Q) UNIFORM in original units, RE-EQUILIBRATES the
    regularized problem, warm-starts the barrier from the prox iterate
    (``prox_cold``: cold), polishes the REGULARIZED subproblem (without
    float-float refinement) and accepts a lane on the loose ORIGINAL-KKT
    criterion; accepted lanes freeze, prox iterates keep advancing.

    Returns (x (12,B), s (24,B), z (24,B), diag (6,B)) in original units,
    diag rows [cert, conv, pr, dr, gap, 0]."""
    r = [[r_in[3 * l + k] for k in range(3)] for l in range(4)]
    b = [b_in[i] for i in range(6)]
    st = [st_in[l] for l in range(4)]
    mu, fzmin, fzmax = mu_in[0], fzmin_in[0], fzmax_in[0]
    iterations, polish, tau, tol = p.iterations, p.polish, p.tau, p.tol

    Qu, c, Grow, h = _assemble(r, b, st, mu, fzmin, fzmax,
                               p.s_diag, p.w_diag, p.swing_relax)
    Qs, cs, Gsr, hs, Dv, Er, nu = _equilibrate_tiles(Qu, c, Grow, h)

    a0_warm = None
    if iterations > 0:
        init = None
        if warm is not None:
            assert len(warm) == 4, "warm barrier needs (x, s, z, st_prev)"
            xin, sin, zin, stprev = warm
            interior = 1e-2
            x0 = [xin[i] / Dv[i] for i in range(N)]
            s0 = [_fmax(sin[rr] * Er[rr], interior) for rr in range(M)]
            z0 = [_fmax(zin[rr] * nu / Er[rr], interior) for rr in range(M)]
            if polish:
                a0_warm = [None] * M
            for rr in range(M):
                leg = rr // 6
                reset = torch.abs(st[leg] - stprev[leg]) > 0.5
                s_cold = _fmax(hs[rr], 1.0)
                s0[rr] = torch.where(reset, s_cold, s0[rr])
                z0[rr] = torch.where(reset, 1.0 / s_cold, z0[rr])
                if polish:
                    a_prev = (zin[rr] > sin[rr]).to(s_cold.dtype)
                    a0_warm[rr] = torch.where(reset, -1.0, a_prev)
            init = (x0, s0, z0)
        x, s, z = _barrier(Qs, cs, Gsr, hs, iterations=iterations, tau=tau,
                           init=init)
    else:
        assert warm is not None, "polish-only mode needs a warm start"
        xin, sin, zin = warm[:3]
        x = [xin[i] / Dv[i] for i in range(N)]
        s = [_fmax(sin[rr] * Er[rr], 1e-30) for rr in range(M)]
        z = [_fmax(zin[rr] * nu / Er[rr], 1e-30) for rr in range(M)]
    if polish:
        a0 = None
        if a0_warm is not None:
            a0 = [torch.where(a0_warm[rr] < -0.5,
                              (z[rr] > s[rr]).to(z[rr].dtype),
                              a0_warm[rr]) for rr in range(M)]
        x, s, z, cert = _polish(Qs, cs, Gsr, hs, x, s, z,
                                sweeps=p.polish_sweeps,
                                refine=p.polish_refine, a0=a0,
                                multi_swap=p.polish_multi_swap,
                                ff_refine=p.ff_refine)
        if p.prox_steps > 0:
            interior_p = 1e-2
            # As a tensor: ``float / tensor`` is reciprocal-then-multiply in
            # PyTorch (two roundings), the kernel divides once.
            interior_pt = torch.full_like(cert, interior_p)
            d2 = [Dv[i] * Dv[i] for i in range(N)]
            mean_diag = torch.zeros_like(d2[0])
            for i in range(N):
                mean_diag = mean_diag + 1.0 / d2[i]
            mean_diag = mean_diag * _f32(1.0 / N)
            rho_orig = _f32(p.prox_rho) * mean_diag
            psw = p.polish_sweeps if p.prox_sweeps is None else p.prox_sweeps
            # Prox iterate in ORIGINAL units.
            xko = [x[i] * Dv[i] for i in range(N)]
            sko = [s[rr] / Er[rr] for rr in range(M)]
            zko = [z[rr] * Er[rr] / nu for rr in range(M)]
            # Acceptance mask: once a lane holds a strict-certified OR
            # loose-tol point, later prox steps must not overwrite it.
            # ``cert`` itself stays the STRICT certificate (diag row 0).
            acc = (cert > 0.5).to(cert.dtype)

            for _k in range(p.prox_steps):
                Qup = [[None] * N for _ in range(N)]
                for i in range(N):
                    for j in range(i, N):
                        Qup[i][j] = (Qu[i][j] + rho_orig if i == j
                                     else Qu[i][j])
                cko = [c[i] - rho_orig * xko[i] for i in range(N)]
                Qsp, csp, Gsp, hsp, Dvp, Erp, nup = _equilibrate_tiles(
                    Qup, cko, Grow, h)
                if p.prox_cold:
                    initp = None
                else:
                    x0p = [xko[i] / Dvp[i] for i in range(N)]
                    s0p = [_fmax(sko[rr] * Erp[rr], interior_p)
                           for rr in range(M)]
                    z0p = [_fmax(zko[rr] * nup / Erp[rr],
                                 interior_pt / s0p[rr]) for rr in range(M)]
                    initp = (x0p, s0p, z0p)
                xbp, sbp, zbp = _barrier(Qsp, csp, Gsp, hsp,
                                         iterations=p.prox_iterations,
                                         tau=tau, init=initp)
                a0p = [(zbp[rr] > sbp[rr]).to(cert.dtype) for rr in range(M)]
                xp2p, sp2p, zp2p, _cert_reg = _polish(
                    Qsp, csp, Gsp, hsp, xbp, sbp, zbp,
                    sweeps=psw, refine=p.polish_refine, a0=a0p,
                    multi_swap=p.polish_multi_swap, ff_refine=False)
                # Primed coords -> original -> the OUTER equilibrated
                # coords the output lives in.
                xko = [xp2p[i] * Dvp[i] for i in range(N)]
                sko = [sp2p[rr] / Erp[rr] for rr in range(M)]
                zko = [zp2p[rr] * Erp[rr] / nup for rr in range(M)]
                xp2 = [xko[i] / Dv[i] for i in range(N)]
                sp2 = [_fmax(sko[rr] * Er[rr], 1e-30) for rr in range(M)]
                zp2 = [_fmax(zko[rr] * nu / Er[rr], 1e-30)
                       for rr in range(M)]
                loose2 = _loose_conv(Qu, c, Grow, h, Dv, Er, nu,
                                     xp2, sp2, zp2, tol)
                newly = loose2 & (acc < 0.5)
                x = [torch.where(newly, xp2[i], x[i]) for i in range(N)]
                s = [torch.where(newly, sp2[rr], s[rr]) for rr in range(M)]
                z = [torch.where(newly, zp2[rr], z[rr]) for rr in range(M)]
                acc = torch.where(newly, 1.0, acc)
    else:
        cert = torch.zeros_like(x[0])

    # Map back to original units (solve_qp_ipm's inverse scaling).
    inv_nu = 1.0 / nu
    xo = [x[i] * Dv[i] for i in range(N)]
    zo = [z[rr] * Er[rr] * inv_nu for rr in range(M)]
    so = [s[rr] / Er[rr] for rr in range(M)]

    # Diagnostics in ORIGINAL units, then the scaled-units criterion (the
    # residuals the barrier actually controls: in original units the f32
    # complementarity floor is inflated by the 1e4 swing-row slacks).
    conv_o, pr, dr, gap = _kkt_flags(Qu, c, Grow, h, xo, so, zo, tol)
    conv_s = _kkt_flags(Qs, cs, Gsr, hs, x, s, z, tol)[0]
    conv = conv_o | (cert > 0.5) | conv_s

    diag = torch.stack([cert, conv.to(cert.dtype), pr, dr, gap,
                        torch.zeros_like(cert)])
    return torch.stack(xo), torch.stack(so), torch.stack(zo), diag


def _assembly_plain(r_in, b_in, st_in, mu_in, fzmin_in, fzmax_in, *,
                    s_diag, w_diag, swing_relax, equilibrated):
    """Plain PyTorch version of the assembly kernel (K2) on (k, B) tensors:
    the (optionally equilibrated) QP written out dense, as (144, B), (12,
    B), (288, B), (24, B)."""
    r = [[r_in[3 * l + k] for k in range(3)] for l in range(4)]
    b = [b_in[i] for i in range(6)]
    st = [st_in[l] for l in range(4)]
    Qu, c, Grow, h = _assemble(r, b, st, mu_in[0], fzmin_in[0], fzmax_in[0],
                               s_diag, w_diag, swing_relax)
    if equilibrated:
        Qu, c, Grow, h, _, _, _ = _equilibrate_tiles(Qu, c, Grow, h)
    zero = torch.zeros_like(c[0])
    Q = [_sym(Qu, i, j) for i in range(N) for j in range(N)]
    G = []
    for rr in range(M):
        vals = dict(Grow[rr])
        leg = rr // 6
        for j in range(N):
            k = j - 3 * leg
            G.append(vals[k] if k in vals else zero)
    return torch.stack(Q), torch.stack(c), torch.stack(G), torch.stack(h)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _soa(a, k, B):
    """(B, k) -> contiguous float32 (k, B)."""
    return a.reshape(B, k).to(torch.float32).t().contiguous()


def _bcast_param(v, B, device):
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v.expand(B).reshape(1, B).contiguous()


def _prep_inputs(r_masked, b, stance, mu, fz_min, fz_max):
    B = r_masked.shape[0]
    dev = r_masked.device
    return (_soa(r_masked, N, B), _soa(b, 6, B), _soa(stance, 4, B),
            _bcast_param(mu, B, dev), _bcast_param(fz_min, B, dev),
            _bcast_param(fz_max, B, dev))


def _check_soa(name, a, k, B, device):
    if not torch.is_tensor(a):
        raise TypeError(f"{name}: expected a tensor, got {type(a)}")
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {a.dtype}, the kernel is float32")
    if tuple(a.shape) != (k, B):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                         f"({k}, {B}) (structure of arrays)")
    if not a.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def solve_grf_qp_fused_packed(rp, bp, stp, mup, fminp, fmaxp, *warm_packed,
                              s_diag, w_diag, swing_relax=SWING_ROW_RELAX,
                              iterations: int = 20, polish: bool = True,
                              polish_sweeps: int = _POLISH_SWEEPS_FUSED,
                              polish_refine: int = _POLISH_REFINE,
                              polish_multi_swap: bool = False,
                              tol: float = 3e-5, tau: float = 0.995,
                              rows=None, prox_steps: int = 0,
                              prox_iterations: int = 10,
                              prox_rho: float = 1e-2,
                              prox_sweeps: Optional[int] = None,
                              prox_cold: bool = False,
                              ff_refine: bool = True):
    """The fused GRF-QP kernel (K1) on structure-of-arrays ``(k, B)``
    float32 tensors: ``rp`` (12, B), ``bp`` (6, B), ``stp`` (4, B), ``mup``,
    ``fminp``, ``fmaxp`` (1, B). The zero-copy entry for producers that
    already live in the kernel layout. Returns ``(x (12,B), s (24,B), z
    (24,B), diag (6,B))`` with diag rows [cert, conv, pr, dr, gap, 0].

    ``warm_packed``: optional (x, s, z) triple for polish-only mode
    (iterations == 0), or an (x, s, z, st_prev) 4-tuple for the
    WARM-STARTED barrier (iterations > 0). Passing zeros for (x, s, z) and
    -1 for st_prev reproduces the cold start bitwise — the natural
    first-tick carry init.

    CUDA tensors launch the kernel (one launch, counted in
    ``kernels.launch_counts``); CPU tensors run the plain PyTorch version.
    ``rows`` is ignored (a tile height of the TPU kernel).
    """
    B = rp.shape[1]
    device = rp.device
    for name, a, k in (("rp", rp, N), ("bp", bp, 6), ("stp", stp, 4),
                       ("mup", mup, 1), ("fminp", fminp, 1),
                       ("fmaxp", fmaxp, 1)):
        _check_soa(name, a, k, B, device)
    has_warm = len(warm_packed) in (3, 4)
    if warm_packed and not has_warm:
        raise ValueError(
            "warm_packed must be (x, s, z) or (x, s, z, st_prev)")
    has_st_prev = len(warm_packed) == 4
    if has_st_prev and iterations == 0:
        raise ValueError("(x, s, z, st_prev) warm start needs iterations > 0")
    if has_warm and not has_st_prev and iterations != 0:
        raise ValueError("(x, s, z) warm is polish-only (iterations == 0); "
                         "pass st_prev too for a warm-started barrier")
    if iterations == 0 and not has_warm:
        raise ValueError("iterations == 0 (polish-only) needs a warm start")
    if prox_steps > 0 and not polish:
        raise ValueError("prox_steps > 0 requires polish=True")
    for name, a, k in zip(("xw", "sw", "zw", "st_prev"), warm_packed,
                          (N, M, M, 4)):
        _check_soa(name, a, k, B, device)

    sched = FusedSchedule(
        s_diag=tuple(float(v) for v in s_diag), w_diag=float(w_diag),
        swing_relax=float(swing_relax), iterations=int(iterations),
        tau=float(tau), tol=float(tol), polish=bool(polish),
        polish_sweeps=int(polish_sweeps), polish_refine=int(polish_refine),
        polish_multi_swap=bool(polish_multi_swap),
        prox_steps=int(prox_steps), prox_iterations=int(prox_iterations),
        prox_rho=float(prox_rho),
        prox_sweeps=None if prox_sweeps is None else int(prox_sweeps),
        prox_cold=bool(prox_cold), ff_refine=bool(ff_refine))

    if device.type == "cpu":
        return _fused_plain(rp, bp, stp, mup, fminp, fmaxp,
                            warm_packed if has_warm else None, sched)
    return kernels.fused_solve(rp, bp, stp, mup, fminp, fmaxp,
                               warm_packed, sched)


def solve_grf_qp_fused(r_masked, b, stance, mu, fz_min, fz_max, *,
                       s_diag, w_diag, swing_relax=SWING_ROW_RELAX,
                       iterations: int = 20, polish: bool = True,
                       polish_sweeps: int = _POLISH_SWEEPS_FUSED,
                       polish_refine: int = _POLISH_REFINE,
                       polish_multi_swap: bool = False,
                       tol: float = 3e-5, tau: float = 0.995,
                       rows=None, warm=None, warm_stance_prev=None,
                       prox_steps: int = 0, prox_iterations: int = 10,
                       prox_rho: float = 1e-2,
                       prox_sweeps: Optional[int] = None,
                       prox_cold: bool = False,
                       ff_refine: bool = True) -> IPMSolution:
    """Fused assembly + solve of the batched GRF QP from raw SRB state.

    Args:
      r_masked: (B, 4, 3) stance-masked world-frame CoM->foot vectors
        (R @ p_foot, zeroed for swing legs — srb_dynamics' com_ft_masked).
      b: (B, 6) SRB Newton-Euler rhs [m(xddot_d + g); Iw wdot_d + w x Iw w].
      stance: (B, 4) bool/float stance mask.
      mu, fz_min, fz_max: scalars or (B,) per-instance cone parameters.
      s_diag / w_diag: objective weights (tuple of 6, float).
      rows: ignored (tile height of the TPU kernel); any B is accepted.
      warm: optional (x, s, z) in ORIGINAL units. With iterations == 0:
        polish-only mode. With iterations > 0: WARM-STARTED barrier —
        interior-shifted, with cone rows reset cold for legs whose stance
        differs from ``warm_stance_prev``.
      warm_stance_prev: (B, 4) stance mask the warm point was solved under
        (warm-barrier mode only). Defaults to ``stance`` (no resets).

    The tensors' device decides the path: CUDA launches the kernel, CPU runs
    its plain PyTorch version. Returns IPMSolution in original units.
    """
    B = r_masked.shape[0]
    inputs = list(_prep_inputs(r_masked, b, stance, mu, fz_min, fz_max))
    if warm is not None:
        xw, sw, zw = warm
        inputs += [_soa(xw, N, B), _soa(sw, M, B), _soa(zw, M, B)]
        if iterations > 0:
            stw = stance if warm_stance_prev is None else warm_stance_prev
            stw = torch.as_tensor(stw, device=r_masked.device).to(
                torch.float32).expand(B, 4)
            inputs += [_soa(stw, 4, B)]
    elif warm_stance_prev is not None:
        raise ValueError("warm_stance_prev needs warm")

    xo, so, zo, diag = solve_grf_qp_fused_packed(
        *inputs, s_diag=s_diag, w_diag=w_diag, swing_relax=swing_relax,
        iterations=iterations, polish=polish, polish_sweeps=polish_sweeps,
        polish_refine=polish_refine, polish_multi_swap=polish_multi_swap,
        tol=tol, tau=tau, prox_steps=prox_steps,
        prox_iterations=prox_iterations, prox_rho=prox_rho,
        prox_sweeps=prox_sweeps, prox_cold=prox_cold, ff_refine=ff_refine)
    return _solution_from_packed(xo, so, zo, diag, iterations)


def _solution_from_packed(xo, so, zo, diag, iterations) -> IPMSolution:
    return IPMSolution(
        x=xo.t(), z=zo.t(), s=so.t(), iterations=torch.as_tensor(iterations),
        gap=diag[4], primal_residual=diag[2], dual_residual=diag[3],
        converged=diag[1] > 0.5,
    )


def assemble_qp_fused_debug(r_masked, b, stance, mu, fz_min, fz_max, *,
                            s_diag, w_diag, swing_relax=SWING_ROW_RELAX,
                            equilibrated: bool = False):
    """Run ONLY the kernel-side assembly (K2) and return dense (Q, c, G, h)
    — the parity hook for K1's first two stages against
    ops/dynamics.build_balance_qp and solver/ipm.equilibrate. CUDA tensors
    launch the assembly kernel, CPU tensors its plain PyTorch version."""
    B = r_masked.shape[0]
    inputs = _prep_inputs(r_masked, b, stance, mu, fz_min, fz_max)
    kw = dict(s_diag=tuple(float(v) for v in s_diag), w_diag=float(w_diag),
              swing_relax=float(swing_relax), equilibrated=bool(equilibrated))
    if r_masked.device.type == "cpu":
        Qo, co, Go, ho = _assembly_plain(*inputs, **kw)
    else:
        Qo, co, Go, ho = kernels.assemble(*inputs, **kw)
    return (Qo.t().reshape(B, N, N), co.t(), Go.t().reshape(B, M, N), ho.t())


def solve_grf_qp_fused_split(r_masked, b, stance, mu, fz_min, fz_max, *,
                             s_diag, w_diag, swing_relax=SWING_ROW_RELAX,
                             iterations: int = 20, polish_sweeps: int = 2,
                             polish_refine: int = _POLISH_REFINE,
                             polish_multi_swap: bool = False,
                             tol: float = 3e-5, tau: float = 0.995,
                             barrier_rows=None, polish_rows=None
                             ) -> IPMSolution:
    """Split-phase fused solve: a barrier-only launch (the variant compiled
    without the polish scratch) feeds a polish-only launch — the barrier's
    (x, s, z) round-trips through device memory (60 f32/instance).
    ``barrier_rows`` / ``polish_rows`` are ignored."""
    sol1 = solve_grf_qp_fused(
        r_masked, b, stance, mu, fz_min, fz_max, s_diag=s_diag,
        w_diag=w_diag, swing_relax=swing_relax, iterations=iterations,
        polish=False, tol=tol, tau=tau)
    return solve_grf_qp_fused(
        r_masked, b, stance, mu, fz_min, fz_max, s_diag=s_diag,
        w_diag=w_diag, swing_relax=swing_relax, iterations=0, polish=True,
        polish_sweeps=polish_sweeps, polish_refine=polish_refine,
        polish_multi_swap=polish_multi_swap, tol=tol,
        tau=tau, warm=(sol1.x, sol1.s, sol1.z))


# ---------------------------------------------------------------------------
# Sizes of the compacted re-solve slices: the JAX package's arithmetic
# (solver/pallas_fused.py), from the batch it would pad to.
# ---------------------------------------------------------------------------

def _rows(rows):
    return SUB if rows is None else int(rows)


def padded_batch(B: int, rows=None, multiple: int = 1) -> int:
    """The batch the JAX package pads B to: a multiple of ``rows * 128 *
    multiple`` (pallas_fused.py:1580-1582)."""
    tile = _rows(rows) * LANE * multiple
    return -(-int(B) // tile) * tile


def two_phase_tail_size(B: int, rows=None, tail_divisor: int = 8) -> int:
    """Instances re-solved by the long schedule of the two-phase solve:
    ``Bp // tail_divisor`` of the batch padded to ``rows * 128 *
    tail_divisor`` (pallas_fused.py:1580-1582, :1439), capped at B."""
    Bp = padded_batch(B, rows, tail_divisor)
    return min(Bp // tail_divisor, int(B))


def prox_slice_size(B: int, rows=None, two_phase: bool = False,
                    tail_divisor: int = 8, prox_divisor: int = 64,
                    backend: str = "kernel") -> int:
    """The JAX package's slice size of the ``prox_tail`` stage
    (pallas_fused.py:1632-1634; the kernel backend re-rounds to ``min(rows,
    8) * 128`` and caps at the padded batch, :1652-1655). NOT capped at B:
    the xla backend picks its branch from this number (a multiple of 1024
    runs the dense IPM kernels); the slice the port re-solves is ``min(size,
    B)``."""
    rows = _rows(rows)
    Bp = padded_batch(B, rows, tail_divisor if two_phase else 1)
    Bt = max(Bp // prox_divisor, 1)
    if Bp >= TILE:
        Bt = -(-max(Bt, TILE) // TILE) * TILE
    if backend == "kernel":
        tile_k = min(rows, 8) * LANE
        Bt = min(-(-Bt // tile_k) * tile_k, Bp)
    return Bt


def qp_tail_size(B: int, rows=None, tail_rows=None,
                 tail_divisor: int = 4) -> int:
    """Instances re-solved by the tick's certification tail:
    ``max(Bp // tail_divisor, tail_rows * 128)`` rounded up to ``tail_rows *
    128`` and capped at the padded batch ``Bp`` (pallas_fused.py:1812-1815),
    then at B."""
    Bp = padded_batch(B, rows)
    tile2 = _rows(tail_rows) * LANE
    Bt = max(Bp // tail_divisor, tile2)
    return min(-(-Bt // tile2) * tile2, Bp, int(B))


def _worst_first(converged, count):
    """Indices of the first ``count`` instances with the unconverged ones in
    front (stable order): the compaction of the tail stages."""
    order = torch.argsort(converged.to(torch.int32), stable=True)
    return order[:count]


def _merge_solution(sol: IPMSolution, idx, sol2: IPMSolution) -> IPMSolution:
    """Scatter ``sol2`` (solved on ``sol``'s instances ``idx``) back wherever
    it improved the converged flag."""
    better = sol2.converged & ~sol.converged[idx]

    def merge(a1, a2):
        upd = better.reshape(better.shape + (1,) * (a2.dim() - 1))
        out = a1.clone()
        out[idx] = torch.where(upd, a2, a1[idx])
        return out

    return IPMSolution(
        x=merge(sol.x, sol2.x), z=merge(sol.z, sol2.z),
        s=merge(sol.s, sol2.s), iterations=sol.iterations,
        gap=merge(sol.gap, sol2.gap),
        primal_residual=merge(sol.primal_residual, sol2.primal_residual),
        dual_residual=merge(sol.dual_residual, sol2.dual_residual),
        converged=merge(sol.converged, sol2.converged),
    )


def _dense_slice(args, idx, cfg: BalanceConfig):
    """Dense ``(Q, c, G, h)`` of the compacted slice ``idx`` of the flat
    kernel inputs ``args`` (pallas_fused.py:1687-1699): ``A`` from the
    slice's levers and stance, then ``assemble_qp`` and
    ``cone_constraints``."""
    def take(v):
        return v if v.dim() == 0 else v[idx]

    rm = args[0][idx]          # (Bt, 4, 3) stance-masked world levers
    bb = args[1][idx]          # (Bt, 6)
    stl = args[2][idx] > 0.5   # (Bt, 4)
    eye3 = torch.eye(3, dtype=rm.dtype, device=rm.device)
    top = torch.cat([eye3 * stl[:, l, None, None] for l in range(4)], dim=-1)
    bot = torch.cat([skew(rm[:, l]) for l in range(4)], dim=-1)
    A = torch.cat([top, bot], dim=-2)   # (Bt, 6, 12)
    Qd, cd = assemble_qp(A, bb, cfg)
    Gd, hd = cone_constraints(stl, mu=take(args[3]), fz_min=take(args[4]),
                              fz_max=take(args[5]), cfg=cfg, dtype=rm.dtype)
    return Qd, cd, Gd, hd


def _prox_stage_dense(args, idx, x0, cfg: BalanceConfig, dense: bool, *,
                      prox_rho: float, prox_steps: int, prox_iterations: int
                      ) -> IPMSolution:
    """``prox_backend="xla"`` on the compacted slice ``idx``
    (pallas_fused.py:1686-1733): the dense slice (:func:`_dense_slice`),
    then the proximal restarts from ``x0`` — through the dense IPM kernels
    when ``dense`` (the JAX slice size is a multiple of 1024), else
    ``solve_qp_prox`` — certified against the ORIGINAL KKT at tol 3e-5."""
    from quadruped_control_tpu_torch.solver import fused_ipm  # imports us

    Qd, cd, Gd, hd = _dense_slice(args, idx, cfg)
    if dense:
        return fused_ipm.solve_qp_prox_fused(
            Qd, cd, Gd, hd, x0, rho_rel=prox_rho, prox_steps=prox_steps,
            iterations=prox_iterations, tol=3e-5, device=Qd.device)
    return solve_qp_prox(Qd, cd, Gd, hd, x0=x0, rho_rel=prox_rho,
                         prox_steps=prox_steps, iterations=prox_iterations,
                         tol=3e-5)


def _take_param(v, idx, B, device):
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v if v.dim() == 0 else v.expand(B)[idx]


def solve_grf_qp_fused_two_phase(
        r_masked, b, stance, mu, fz_min, fz_max, *, s_diag, w_diag,
        swing_relax=SWING_ROW_RELAX, iterations: int = 20,
        polish_sweeps: int = 2, polish_refine: int = _POLISH_REFINE,
        polish_multi_swap: bool = False,
        tail_divisor: int = 8, tail_iterations: int = 48,
        tail_sweeps: int = 32, tail_refine: int = 4,
        tail_prox_steps: int = 0, tail_prox_iterations: int = 10,
        tail_prox_rho: float = 1e-2, tail_prox_sweeps: Optional[int] = None,
        tol: float = 3e-5, tau: float = 0.995, rows=None,
        split: bool = False) -> IPMSolution:
    """Two-phase fused solve: cheap schedule for everyone, long schedule for
    the hard tail.

    Phase 1 runs the fused kernel with a SHORT polish (most instances
    certify in 1-2 sweeps). The uncertified tail is compacted to the front
    of a re-solve batch by a stable argsort on the converged flag, run
    through the kernel again with a LONG schedule, and scattered back where
    it improved the flag. ACTIVE-SET SWEEPS are the decisive knob for the
    degenerate 4-stance tail (rank-6 A^T S A + 1e-5 W, condition ~1e6).

    The re-solve batch has :func:`two_phase_tail_size` instances: ``Bp //
    tail_divisor`` of the batch the JAX package pads to a multiple of ``rows
    * 128 * tail_divisor``, capped at B (``rows`` sets this size and nothing
    else; any B is accepted). split=True runs phase 1 as barrier-only +
    polish-only launches (see solve_grf_qp_fused_split).
    """
    B = r_masked.shape[0]
    Bt = two_phase_tail_size(B, rows, tail_divisor)
    common = dict(s_diag=s_diag, w_diag=w_diag, swing_relax=swing_relax,
                  polish_refine=polish_refine,
                  polish_multi_swap=polish_multi_swap, tol=tol, tau=tau)

    if split:
        sol1 = solve_grf_qp_fused_split(
            r_masked, b, stance, mu, fz_min, fz_max, iterations=iterations,
            polish_sweeps=polish_sweeps, **common)
    else:
        sol1 = solve_grf_qp_fused(
            r_masked, b, stance, mu, fz_min, fz_max, iterations=iterations,
            polish=True, polish_sweeps=polish_sweeps, **common)

    idx = _worst_first(sol1.converged, Bt)
    dev = r_masked.device
    # tail_prox_steps > 0 folds the certification prox restarts INTO this
    # same tail launch.
    common["polish_refine"] = (polish_refine if tail_refine is None
                               else tail_refine)
    sol2 = solve_grf_qp_fused(
        r_masked[idx], b[idx], stance[idx], _take_param(mu, idx, B, dev),
        _take_param(fz_min, idx, B, dev), _take_param(fz_max, idx, B, dev),
        iterations=tail_iterations, polish=True, polish_sweeps=tail_sweeps,
        prox_steps=tail_prox_steps, prox_iterations=tail_prox_iterations,
        prox_rho=tail_prox_rho, prox_sweeps=tail_prox_sweeps, **common)

    merged = _merge_solution(sol1, idx, sol2)
    return merged._replace(
        iterations=torch.as_tensor(iterations + tail_iterations))


def srb_rhs(R, w_d, xddot_d, wdot_d, cfg: BalanceConfig,
            mass=None, inertia_diag=None):
    """The SRB Newton-Euler right-hand side b (srb_dynamics' b, without
    materializing A — balance_controller.cpp:237-272)."""
    kw = dict(dtype=R.dtype, device=R.device)
    m = torch.as_tensor(cfg.mass if mass is None else mass, **kw)
    Ib = torch.as_tensor(
        cfg.inertia_diag if inertia_diag is None else inertia_diag, **kw)
    gvec = torch.tensor([0.0, 0.0, cfg.gravity_z_term], **kw)
    b_lin = m[..., None] * (xddot_d + gvec)
    Iw = R * Ib[..., None, :] @ R.transpose(-1, -2)
    Iw_wd = (Iw @ w_d[..., None])[..., 0]
    b_ang = (Iw @ wdot_d[..., None])[..., 0] + torch.linalg.cross(w_d, Iw_wd)
    return torch.cat([b_lin, b_ang], dim=-1)


def balance_precursors(R, R_d, x, xdot, w, x_d, xdot_d, w_d,
                       foot_positions, stance_mask,
                       cfg: BalanceConfig = BalanceConfig(),
                       mass=None, inertia_diag=None):
    """The per-instance precursors the fused kernel starts from: the
    stance-masked world-frame CoM->foot vectors ``r_masked`` (..., 4, 3) and
    the SRB right-hand side ``b`` (..., 6), from raw scenario state (PD
    accelerations, R @ p_foot, Newton-Euler rhs)."""
    xddot_d, wdot_d = pd_accelerations(R, R_d, x, xdot, w, x_d, xdot_d, w_d,
                                       cfg)
    com_ft = torch.einsum("...ij,...lj->...li", R, foot_positions)
    r_masked = torch.where(stance_mask.bool()[..., None], com_ft, 0.0)
    b = srb_rhs(R, w_d, xddot_d, wdot_d, cfg, mass=mass,
                inertia_diag=inertia_diag)
    return r_masked, b


def solve_balance_qp_fused(R, R_d, x, xdot, w, x_d, xdot_d, w_d,
                           foot_positions, stance_mask,
                           cfg: BalanceConfig = BalanceConfig(),
                           mass=None, inertia_diag=None, mu=None,
                           fz_min=None, fz_max=None,
                           iterations: int = 20, polish: bool = True,
                           polish_sweeps: int = _POLISH_SWEEPS_FUSED,
                           polish_refine: int = _POLISH_REFINE,
                           polish_multi_swap: bool = False,
                           rows=None, two_phase: bool = False,
                           tail_divisor: int = 8, tail_iterations: int = 48,
                           tail_sweeps: int = 32, tail_refine: int = 4,
                           tail_prox_steps: int = 0,
                           tail_prox_iterations: int = 10,
                           tail_prox_sweeps: Optional[int] = None,
                           split: bool = False, prox_tail: bool = False,
                           prox_divisor: int = 64, prox_rho: float = 1e-2,
                           prox_steps: int = 4, prox_iterations: int = 30,
                           prox_backend: str = "kernel",
                           prox_sweeps: int = 8, prox_cold: bool = False
                           ) -> IPMSolution:
    """End-to-end fused balance-controller solve: PyTorch computes only the
    tiny per-instance precursors (PD accelerations, masked world foot
    vectors, the 6-vector rhs); assembly and the solve run in the kernel.

    Drop-in replacement for build_balance_qp + solve_qp_ipm (reference hot
    path balance_controller.cpp:98-235). Any batch shape is accepted: inputs
    are flattened (the kernel masks its ragged edge, so nothing is padded)
    and the result is reshaped back. The device of the inputs decides the
    path (CUDA: kernel; CPU: plain version).

    prox_tail=True adds a THIRD phase for certification-critical sweeps: the
    residual uncertified instances (the degenerate 4-stance family the
    kernel tail saturates on) are compacted into a slice of
    :func:`prox_slice_size` instances (the JAX package's size from its
    padded batch, capped at B) and re-solved by proximal restarts.
    prox_backend:

      - ``"kernel"``: the fused kernel's proximal-restart mode (one launch).
      - ``"xla"``: dense assembly of the slice (``assemble_qp``,
        ``cone_constraints``), then ``prox_steps`` restarts of
        :func:`~quadruped_control_tpu_torch.solver.fused_ipm.solve_qp_ipm_fused`
        (the dense barrier K3a + polish K3b, two launches per restart) on
        ``Q + rho I``, certified against the ORIGINAL KKT
        (:func:`~quadruped_control_tpu_torch.solver.fused_ipm.solve_qp_prox_fused`)
        when the JAX slice size is a multiple of 1024; otherwise
        ``solver/ipm.solve_qp_prox``, as in the JAX package. The JAX
        package also takes ``solve_qp_prox`` whenever its kernels run in
        interpret mode; the port has no such mode (the device of the
        tensors picks kernel or plain version, with the same branch).

    ``rows`` sets the slice sizes (two-phase tail and prox slice) as in the
    JAX package and nothing else.
    """
    if prox_tail and prox_backend not in ("kernel", "xla"):
        raise ValueError(f"prox_backend must be 'kernel' or 'xla', got "
                         f"{prox_backend!r}")
    kernels.refuse_grad("solve_balance_qp_fused", R, R_d, x, xdot, w, x_d,
                        xdot_d, w_d, foot_positions, mass, inertia_diag, mu,
                        fz_min, fz_max)
    r_masked, b = balance_precursors(
        R, R_d, x, xdot, w, x_d, xdot_d, w_d, foot_positions, stance_mask,
        cfg, mass=mass, inertia_diag=inertia_diag)

    batch_shape = tuple(torch.broadcast_shapes(
        r_masked.shape[:-2], b.shape[:-1], stance_mask.shape[:-1]))
    B = 1
    for d in batch_shape:
        B *= int(d)
    dev = r_masked.device

    def flat(a, tail):
        return a.expand(batch_shape + tail).reshape((B,) + tail)

    def flat_param(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return v if v.dim() == 0 else flat(v, ())

    args = (
        flat(r_masked, (4, 3)), flat(b, (6,)),
        flat(stance_mask.to(torch.float32), (4,)),
        flat_param(cfg.mu if mu is None else mu),
        flat_param(cfg.fz_min if fz_min is None else fz_min),
        flat_param(cfg.fz_max if fz_max is None else fz_max),
    )
    common = dict(
        s_diag=tuple(cfg.s_diag), w_diag=float(cfg.w_diag),
        polish_sweeps=polish_sweeps, polish_refine=polish_refine,
        polish_multi_swap=polish_multi_swap,
    )
    if two_phase:
        sol = solve_grf_qp_fused_two_phase(
            *args, iterations=iterations, tail_divisor=tail_divisor,
            tail_iterations=tail_iterations, tail_sweeps=tail_sweeps,
            tail_refine=tail_refine, tail_prox_steps=tail_prox_steps,
            tail_prox_iterations=tail_prox_iterations,
            tail_prox_sweeps=tail_prox_sweeps, split=split, rows=rows,
            **common)
    else:
        sol = solve_grf_qp_fused(
            *args, iterations=iterations, polish=polish, **common)
    if prox_tail:
        Bt = prox_slice_size(B, rows, two_phase, tail_divisor, prox_divisor,
                             prox_backend)
        idx = _worst_first(sol.converged, min(Bt, B))
    if prox_tail and prox_backend == "xla":
        psol = _prox_stage_dense(args, idx, sol.x[idx], cfg, Bt % TILE == 0,
                                 prox_rho=prox_rho, prox_steps=prox_steps,
                                 prox_iterations=prox_iterations)
        sol = _merge_solution(sol, idx, psol)
    elif prox_tail:
        # The kernel's proximal restarts on the compacted slice — one launch;
        # certify-against-original-KKT semantics.
        psol = solve_grf_qp_fused(
            args[0][idx], args[1][idx], args[2][idx],
            _take_param(args[3], idx, B, dev),
            _take_param(args[4], idx, B, dev),
            _take_param(args[5], idx, B, dev),
            s_diag=tuple(cfg.s_diag), w_diag=float(cfg.w_diag),
            iterations=0, polish=True, polish_sweeps=prox_sweeps,
            # The refine depth of the earlier phases, so the prox stage
            # certifies under the SAME arithmetic.
            polish_refine=polish_refine,
            warm=(sol.x[idx], sol.s[idx], sol.z[idx]),
            prox_steps=prox_steps, prox_iterations=prox_iterations,
            prox_rho=prox_rho, prox_sweeps=prox_sweeps,
            prox_cold=prox_cold)
        sol = _merge_solution(sol, idx, psol)

    if len(batch_shape) == 1:
        return sol

    def unflat(a, tail):
        return a.reshape(batch_shape + tail)

    return IPMSolution(
        x=unflat(sol.x, (N,)), z=unflat(sol.z, (M,)), s=unflat(sol.s, (M,)),
        iterations=sol.iterations, gap=unflat(sol.gap, ()),
        primal_residual=unflat(sol.primal_residual, ()),
        dual_residual=unflat(sol.dual_residual, ()),
        converged=unflat(sol.converged, ()),
    )


def solve_grf_qp_tail_packed(rp, bp, stp, mup, fminp, fmaxp,
                             xp, sp, zp, diagp, *, s_diag, w_diag,
                             swing_relax=SWING_ROW_RELAX,
                             tail_divisor: int = 4, rows=None,
                             tail_rows=None, tail_sweeps: int = 24,
                             tail_refine: int = _POLISH_REFINE,
                             tail_prox_steps: int = 2,
                             tail_prox_iterations: int = 8,
                             tail_prox_rho: float = 1e-2,
                             tail_prox_sweeps: Optional[int] = None,
                             tol: float = 3e-5, tau: float = 0.995,
                             tail_ff: bool = False):
    """Certification tail for an in-loop solve, on the kernel layout.

    Takes the ``(k, B)`` inputs + phase-1 solution of
    :func:`solve_grf_qp_fused_packed` (typically a warm barrier-only tick
    solve), compacts the UNCERTIFIED instances to a slice of
    :func:`qp_tail_size` instances by a stable argsort on the converged
    flag, and re-solves only that slice with the long warm-seeded polish +
    proximal restarts. The slice size is the JAX package's: ``max(Bp //
    tail_divisor, tail_rows * 128)`` rounded up to ``tail_rows * 128``, with
    ``Bp`` the batch padded to ``rows * 128`` (the main kernel's tile
    height), capped at B; ``rows`` and ``tail_rows`` (default 8 each) set
    this size and nothing else. Improved instances scatter back into (x, s, z, diag), so a
    warm carry ALSO inherits the certified triple.

    The strict-certificate bit (diag row 0) comes from the tail solve's OWN
    diag: a lane merged on the loose conv flag (row 1) takes the tail
    solve's whole diag column and never inherits an unearned strict bit.
    ``tail_ff`` defaults to False: the reference
    measured float-float refinement trajectory-divergent in its closed loop.
    Returns updated (x, s, z, diag) in the same layout.
    """
    B = rp.shape[1]
    Bt = qp_tail_size(B, rows, tail_rows, tail_divisor)
    conv = diagp[1] > 0.5
    idx = _worst_first(conv, Bt)

    def take(a):
        return a[:, idx].contiguous()

    x2, s2, z2, d2 = solve_grf_qp_fused_packed(
        take(rp), take(bp), take(stp), take(mup), take(fminp), take(fmaxp),
        take(xp), take(sp), take(zp),
        s_diag=s_diag, w_diag=w_diag, swing_relax=swing_relax,
        iterations=0, polish=True, polish_sweeps=tail_sweeps,
        polish_refine=tail_refine, tol=tol, tau=tau,
        prox_steps=tail_prox_steps, prox_iterations=tail_prox_iterations,
        prox_rho=tail_prox_rho, prox_sweeps=tail_prox_sweeps,
        ff_refine=tail_ff)
    better = (d2[1] > 0.5) & ~conv[idx]

    def merge(a1, a2):
        out = a1.clone()
        out[:, idx] = torch.where(better[None, :], a2, a1[:, idx])
        return out

    return merge(xp, x2), merge(sp, s2), merge(zp, z2), merge(diagp, d2)
