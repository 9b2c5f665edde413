"""Single-rigid-body balance dynamics and GRF-QP assembly.

PyTorch re-implementation of ``BalanceController``'s numerical core
(reference balance_controller.cpp). The reference builds, per control tick:

  - PD accelerations on the CoM pose (balance_controller.cpp:126-139),
  - the SRB Newton-Euler system ``A f = b`` with A = [I..I; skew(R p_i)..]
    (balance_controller.cpp:237-272),
  - the QP ``min |Af-b|^2_S + f^T W f`` in standard form Q = 2(A^T S A + W),
    c = -2 A^T S b (balance_controller.cpp:152-153),
  - a 20-row two-sided friction-pyramid constraint with +-1e6 big-M bounds,
    zeroing swing legs' rows to force their forces to 0
    (balance_controller.cpp:274-330).

Solver-friendly reformulation (exact, see notes below):

  1. Swing legs are eliminated by *masking A's columns* instead of pinning
     forces with 0..0 constraint rows. With the columns zeroed, the QP
     block-decouples: the swing block reduces to ``min f^T W f`` whose unique
     minimizer is f = 0 — identical to the reference's equality-pinned
     solution — while the stance block is untouched (cross terms in
     A^T S A vanish). This avoids equality-degenerate rows that stall
     interior-point methods.
  2. The 20 two-sided rows expand to exactly 24 one-sided rows ``G f <= h``
     (6 per leg); the +-1e6 big-M sides are dropped because they can never be
     active (|fx|,|fy| <= mu * fz_max << 1e6). Swing-leg rows get a relaxed
     bound so f = 0 is strictly interior.

Everything is batched: leading dimensions broadcast, so one call assembles
thousands of QP instances for the batched solver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch.config import GRAVITY, BalanceConfig
from quadruped_control_tpu_torch.math.rotations import skew, so3_log

NUM_VARS = 12
NUM_CONE_ROWS = 24  # 6 one-sided rows per leg
SWING_ROW_RELAX = 1.0e4  # strictly-feasible slack for swing-leg rows


class QPData(NamedTuple):
    """One (batch of) GRF QP(s) in standard inequality form.

    min_x 1/2 x^T Q x + c^T x  s.t.  G x <= h
    """

    Q: torch.Tensor  # (..., 12, 12)
    c: torch.Tensor  # (..., 12)
    G: torch.Tensor  # (..., 24, 12)
    h: torch.Tensor  # (..., 24)


def pd_accelerations(R, R_d, x, xdot, w, x_d, xdot_d, w_d,
                     cfg: BalanceConfig = BalanceConfig()):
    """Desired CoM linear/angular accelerations ([R1] Eq 3-4,
    balance_controller.cpp:126-139).

    Returns (xddot_d, wdot_d), each (..., 3).

    Behavioral parity note: the reference's yaw feed-forward writes
    ``wdot_d(1) += kff(5) * w_d(2)`` — index 1, not 2
    (balance_controller.cpp:139, a known typo). We reproduce it exactly; the
    shipped preset has kff[5] = 0 so it is numerically inert, but scenario
    parity demands the same formula.
    """
    kw = dict(dtype=x.dtype, device=x.device)
    kp_p = torch.tensor(cfg.kp_p, **kw)
    kd_p = torch.tensor(cfg.kd_p, **kw)
    kp_w = torch.tensor(cfg.kp_w, **kw)
    kd_w = torch.tensor(cfg.kd_w, **kw)
    kff = torch.tensor(cfg.kff, **kw)

    xddot_d = kp_p * (x_d - x) + kd_p * (xdot_d - xdot)
    xddot_d = xddot_d + torch.stack(
        [
            kff[0] * xdot_d[..., 0],
            kff[1] * xdot_d[..., 1],
            (kff[2] * cfg.mass * GRAVITY).expand(x[..., 0].shape),
        ],
        dim=-1,
    )

    # R_error = Rwb_d @ Rwb^T -> total angle-axis (balance_controller.cpp:133-136).
    R_error = R_d @ R.transpose(-1, -2)
    wdot_d = kp_w * so3_log(R_error) + kd_w * (w_d - w)
    wdot_d = wdot_d + torch.stack(
        [
            kff[3] * w_d[..., 0],
            kff[4] * w_d[..., 1] + kff[5] * w_d[..., 2],  # ref typo preserved
            torch.zeros_like(w_d[..., 2]),
        ],
        dim=-1,
    )
    return xddot_d, wdot_d


def srb_dynamics(foot_positions, R, xddot_d, w_d, wdot_d,
                 cfg: BalanceConfig = BalanceConfig(), stance_mask=None,
                 mass=None, inertia_diag=None):
    """SRB Newton-Euler system A f = b ([R1] Eq 5,
    balance_controller.cpp:237-272).

    A is 6x12: top = 4 identity blocks, bottom = skew(R @ p_foot_i) blocks
    (CoM-to-foot vectors in world frame). b = [m (xddot_d + g);
    Iw wdot_d + w_d x (Iw w_d)] with Iw = R Ib R^T.

    Args:
      foot_positions: (..., 4, 3) feet in the body frame.
      stance_mask: optional (..., 4) bool; swing columns of A are zeroed
        (swing elimination by masking — see module docstring).
      mass / inertia_diag: optional per-instance overrides (...,) / (..., 3)
        for domain randomization; default from cfg.
    Returns:
      (A, b): (..., 6, 12) and (..., 6).
    """
    dtype, device = foot_positions.dtype, foot_positions.device
    m = torch.as_tensor(cfg.mass if mass is None else mass, dtype=dtype,
                        device=device)
    Ib_diag = torch.as_tensor(
        cfg.inertia_diag if inertia_diag is None else inertia_diag,
        dtype=dtype, device=device
    )

    # CoM->foot vectors in world frame (balance_controller.cpp:243-248).
    com_ft = torch.einsum("...ij,...lj->...li", R, foot_positions)
    if stance_mask is not None:
        com_ft_masked = torch.where(stance_mask[..., None], com_ft, 0.0)
    else:
        com_ft_masked = com_ft

    batch = com_ft.shape[:-2]
    eye = torch.eye(3, dtype=dtype, device=device).expand(
        tuple(batch) + (4, 3, 3))
    if stance_mask is not None:
        eye = torch.where(stance_mask[..., None, None], eye, 0.0)
    top = torch.cat([eye[..., l, :, :] for l in range(4)], dim=-1)
    bottom = torch.cat(
        [skew(com_ft_masked[..., l, :]) for l in range(4)], dim=-1
    )
    A = torch.cat([top, bottom], dim=-2)

    # The gravity term's sign is configurable: the reference codes
    # b = m (xddot_d + g) with g_z = -9.81 (balance_controller.cpp:78, 265),
    # the physically-consistent form uses +9.81 (see config.BalanceConfig).
    gvec = torch.tensor([0.0, 0.0, cfg.gravity_z_term], dtype=dtype,
                        device=device)
    b_lin = m[..., None] * (xddot_d + gvec)

    # Iw = R Ib R^T with diagonal Ib (balance_controller.cpp:251).
    Iw = R * Ib_diag[..., None, :] @ R.transpose(-1, -2)
    Iw_wd = (Iw @ w_d[..., None])[..., 0]
    b_ang = (Iw @ wdot_d[..., None])[..., 0] + torch.linalg.cross(w_d, Iw_wd)

    b = torch.cat([b_lin, b_ang], dim=-1)
    return A, b


def friction_cone_rows(mu, dtype=torch.float32, device=None):
    """Per-leg 6x3 one-sided cone rows (from [R1] Eq 7-8,
    balance_controller.cpp:274-292 collapsed to the active-relevant sides).

        fx - mu fz <= 0      (ref row 1 upper)
        fy - mu fz <= 0      (ref row 2 upper)
       -fy - mu fz <= 0      (ref row 3 lower, negated)
       -fx - mu fz <= 0      (ref row 4 lower, negated)
        fz        <= fz_max  (ref row 5 upper)
       -fz        <= -fz_min (ref row 5 lower, negated)

    Args:
      mu: scalar or (...,) friction coefficient.
    Returns:
      (..., 6, 3).
    """
    if not torch.is_tensor(mu):
        from quadruped_control_tpu_torch import resolve_device

        device = resolve_device(device)
    mu = torch.as_tensor(mu, dtype=dtype, device=device)
    one = torch.ones_like(mu)
    zero = torch.zeros_like(mu)

    def row(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    return torch.stack(
        [
            row(one, zero, -mu),
            row(zero, one, -mu),
            row(zero, -one, -mu),
            row(-one, zero, -mu),
            row(zero, zero, one),
            row(zero, zero, -one),
        ],
        dim=-2,
    )


def cone_constraints(stance_mask, mu=None, fz_min=None, fz_max=None,
                     cfg: BalanceConfig = BalanceConfig(), dtype=torch.float32):
    """Full (..., 24, 12) G and (..., 24) h from the gait's stance mask
    (replaces ``frictionConeBounds``, balance_controller.cpp:294-330).

    Swing legs keep their rows but with bound ``SWING_ROW_RELAX`` so f = 0 is
    strictly interior (the objective-side masking already pins their forces).
    """
    kw = dict(dtype=dtype, device=stance_mask.device)
    mu = torch.as_tensor(cfg.mu if mu is None else mu, **kw)
    fz_min = torch.as_tensor(cfg.fz_min if fz_min is None else fz_min, **kw)
    fz_max = torch.as_tensor(cfg.fz_max if fz_max is None else fz_max, **kw)

    rows = friction_cone_rows(mu, dtype=dtype)  # (..., 6, 3)
    batch = tuple(torch.broadcast_shapes(
        rows.shape[:-2], stance_mask.shape[:-1], fz_min.shape, fz_max.shape
    ))
    rows = rows.expand(batch + (6, 3))

    # Block-diagonal G: leg l occupies rows 6l..6l+5, cols 3l..3l+2.
    G = torch.zeros(batch + (NUM_CONE_ROWS, NUM_VARS), **kw)
    for leg in range(4):
        G[..., 6 * leg : 6 * leg + 6, 3 * leg : 3 * leg + 3] = rows

    zeros = torch.zeros(batch, **kw)
    h_leg = torch.stack(
        [zeros, zeros, zeros, zeros,
         fz_max.expand(batch),
         (-fz_min).expand(batch)],
        dim=-1,
    )  # (..., 6)
    h_stance = h_leg.repeat((1,) * len(batch) + (4,))
    stance_rep = torch.repeat_interleave(stance_mask.bool(), 6, dim=-1)
    h = torch.where(stance_rep, h_stance, SWING_ROW_RELAX)
    return G, h


def assemble_qp(A, b, cfg: BalanceConfig = BalanceConfig(), S_diag=None,
                w_diag=None):
    """QP standard form from the SRB system (balance_controller.cpp:152-153):
    Q = 2 (A^T S A + W), c = -2 A^T S b.

    Args:
      A: (..., 6, 12), b: (..., 6).
      S_diag / w_diag: optional per-instance overrides.
    Returns:
      (Q, c).
    """
    kw = dict(dtype=A.dtype, device=A.device)
    S_diag = torch.as_tensor(cfg.s_diag if S_diag is None else S_diag, **kw)
    w_diag = torch.as_tensor(cfg.w_diag if w_diag is None else w_diag, **kw)

    SA = S_diag[..., None] * A
    Q = 2.0 * (A.transpose(-1, -2) @ SA)
    Q = Q + (2.0 * w_diag)[..., None, None] * torch.eye(NUM_VARS, **kw)
    c = -2.0 * torch.einsum("...ij,...i->...j", SA, b)
    return Q, c


def build_balance_qp(R, R_d, x, xdot, w, x_d, xdot_d, w_d, foot_positions,
                     stance_mask, cfg: BalanceConfig = BalanceConfig(),
                     mass=None, inertia_diag=None, mu=None, fz_min=None,
                     fz_max=None, S_diag=None, w_diag=None) -> QPData:
    """End-to-end QP assembly for the balance controller's hot path
    (balance_controller.cpp:98-161). Fully batched; all optional parameter
    overrides broadcast for domain randomization."""
    xddot_d, wdot_d = pd_accelerations(R, R_d, x, xdot, w, x_d, xdot_d, w_d, cfg)
    A, b = srb_dynamics(foot_positions, R, xddot_d, w_d, wdot_d, cfg,
                        stance_mask=stance_mask, mass=mass,
                        inertia_diag=inertia_diag)
    Q, c = assemble_qp(A, b, cfg, S_diag=S_diag, w_diag=w_diag)
    G, h = cone_constraints(stance_mask, mu=mu, fz_min=fz_min, fz_max=fz_max,
                            cfg=cfg, dtype=Q.dtype)
    return QPData(Q=Q, c=c, G=G, h=h)


def forces_to_body_frame(fw, R, stance_mask):
    """QP world-frame solution -> per-leg body-frame forces
    (balance_controller.cpp:218-232): f_b = -R^T f_w for stance legs, zero
    for swing legs.

    Args:
      fw: (..., 12) world-frame GRF solution.
      R: (..., 3, 3).
    Returns:
      (..., 4, 3).
    """
    fw_legs = fw.reshape(fw.shape[:-1] + (4, 3))
    fb = -torch.einsum("...ji,...lj->...li", R, fw_legs)
    return torch.where(stance_mask[..., None], fb, 0.0)
