"""N physics substeps of the whole-body plant as one kernel (K5), on
structure-of-arrays ``(k, B)`` tensors (counterpart of
``quadruped_control_tpu/sim/pallas_substep.py``).

One launch runs the torque-map prologue (``f_b = -R^T f_w``, ``tau = J^T
f_b``, stance/swing merge, optional leg gravity compensation, clamp), the
once-per-tick mass-matrix factor (composite-rigid-body assembly of the
tree-sparse blocks + Schur prefactor + Cholesky 6x6 inverse), and then
``n_substeps`` x (RNEA bias, 8-point compliant contact with anchor stiction
or Coulomb friction, prefactored tree solve, semi-implicit step, Rodrigues,
velocity clamp, freeze-on-nonfinite).

The factor is computed once per control tick (exactly like
``whole_body_step(m_update="tick")``) and held across the substeps.

State layout (k axis), all (B,):
  0:9 R row-major | 9:12 x | 12:30 u (w_b, v_b, qdot) | 30:42 q |
  42:58 anchor (8 x 2)
Streamed factor layout (``prefactor="xla"``), 216 comps:
  0:36 Dinv (4 x 3x3) | 36:108 Bl (4 x 6x3) | 108:180 BDinv (4 x 6x3) |
  180:216 Sinv (6x6)

The model, the contact parameters and the torque limits are RUNTIME
arguments of the CUDA kernel (csrc/qct_substep.cu), as are ``n_substeps`` and
the substep length: both model presets, every ``ContactConfig`` and all four
``prefactor`` x ``torque_input`` combinations run on one compiled kernel.
CPU tensors run the plain PyTorch version below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import GRAVITY, ControlConfig
from quadruped_control_tpu_torch.ops.dynamics import forces_to_body_frame
from quadruped_control_tpu_torch.ops.kinematics import (
    jacobian_transpose_control,
)
from quadruped_control_tpu_torch.math.rotations import skew
from quadruped_control_tpu_torch.sim import plant as _plant
from quadruped_control_tpu_torch.sim.dynamics import (
    MassFactor,
    _inv3,
    leg_gravity_torques,
    mass_matrix,
    precompute_leg_kinematics,
    prefactor_mass_matrix,
)
from quadruped_control_tpu_torch.sim.model import WholeBodyModel
from quadruped_control_tpu_torch.sim.plant import ContactConfig, WholeBodyState

N_STATE = 58
N_FACTOR = 216


class SubstepConsts(NamedTuple):
    """Float64 NumPy snapshot of everything the kernel takes (the CUDA
    launcher copies it into a by-value struct, kernels.SubstepParams)."""

    trunk_m: float
    trunk_I: np.ndarray  # (3,) diagonal
    link_m: np.ndarray  # (4, 3)
    link_c: np.ndarray  # (4, 3, 3)
    link_I: np.ndarray  # (4, 3, 3) diagonals
    leaf_h: np.ndarray  # (4, 3, 3) m * c
    leaf_J: np.ndarray  # (4, 3, 3, 3) inertia about the link-frame origin
    joint_r: np.ndarray  # (4, 3, 3)
    damp: np.ndarray  # (4, 3)
    armature: np.ndarray  # (4, 3)
    hips: np.ndarray  # (4, 3)
    l1s: np.ndarray  # (4,)
    sl2: float
    sl3: float
    k_n: float
    d_n: float
    mu: float
    kt: float
    ct: float
    v_s: float
    trunk_cz: float
    tau_min: float
    tau_max: float
    gravity: float
    use_anchor: bool
    torque_qp: bool
    gravity_comp: bool
    prefactor_kernel: bool


def _snapshot(model, cfg, contact, prefactor, torque_input, gravity_comp):
    mdl = {k: np.asarray(v.detach().cpu().numpy(), np.float64)
           for k, v in model._asdict().items()}
    trunk_I = mdl["trunk_inertia"]
    if not np.allclose(trunk_I, np.diag(np.diag(trunk_I))):
        raise ValueError("the fused stepper assumes a diagonal trunk inertia")
    link_I = mdl["link_inertia"]
    link_m, link_c = mdl["link_mass"], mdl["link_com"]
    leaf_J = np.zeros((4, 3, 3, 3))
    for leg in range(4):
        for j in range(3):
            if not np.allclose(link_I[leg, j],
                               np.diag(np.diag(link_I[leg, j]))):
                raise ValueError(
                    "the fused stepper assumes diagonal link inertias")
            c = link_c[leg, j]
            leaf_J[leg, j] = link_I[leg, j] + link_m[leg, j] * (
                float(c @ c) * np.eye(3) - np.outer(c, c))
        axes = mdl["joint_axes"][leg]
        if not (np.allclose(axes[0], [1, 0, 0]) and np.allclose(
                axes[1], [0, 1, 0]) and np.allclose(axes[2], [0, 1, 0])):
            raise ValueError(
                "the fused stepper assumes joint axes x (abad), y, y")
    kin = cfg.kinematics
    return SubstepConsts(
        trunk_m=float(mdl["trunk_mass"]), trunk_I=np.diag(trunk_I).copy(),
        link_m=link_m, link_c=link_c,
        link_I=np.stack([[np.diag(link_I[leg, j]) for j in range(3)]
                         for leg in range(4)]),
        leaf_h=link_m[..., None] * link_c, leaf_J=leaf_J,
        joint_r=mdl["joint_offsets"], damp=mdl["joint_damping"],
        armature=mdl["armature"], hips=kin.hip_offsets_np(),
        l1s=kin.l1_signed_np(), sl2=-float(kin.l2), sl3=-float(kin.l3),
        k_n=float(contact.stiffness), d_n=float(contact.dissipation),
        mu=float(contact.mu), kt=float(contact.tangent_stiffness),
        ct=float(contact.tangent_damping),
        v_s=float(contact.stiction_velocity),
        trunk_cz=float(contact.trunk_contact_z),
        tau_min=float(cfg.balance.torque_min),
        tau_max=float(cfg.balance.torque_max), gravity=GRAVITY,
        use_anchor=contact.tangential == "anchor",
        torque_qp=torque_input == "qp", gravity_comp=bool(gravity_comp),
        prefactor_kernel=prefactor == "kernel")


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def state_to_comps(state: WholeBodyState):
    """WholeBodyState with batch shape (B,) -> (58, B)."""
    B = state.x.shape[0]
    return torch.cat([
        state.R.reshape(B, 9), state.x, state.u, state.q.reshape(B, 12),
        state.anchor.reshape(B, 16)], dim=-1).t().contiguous()


def comps_to_state(state_p) -> WholeBodyState:
    """(58, B) -> WholeBodyState with batch shape (B,)."""
    flat = state_p.t()
    B = flat.shape[0]
    return WholeBodyState(
        R=flat[:, 0:9].reshape(B, 3, 3), x=flat[:, 9:12],
        u=flat[:, 12:30], q=flat[:, 30:42].reshape(B, 4, 3),
        anchor=flat[:, 42:58].reshape(B, 8, 2))


def factor_to_comps(fac: MassFactor):
    """MassFactor with batch shape (B,) -> (216, B)."""
    B = fac.Sinv.shape[0]
    return torch.cat([
        fac.Dinv.reshape(B, 36), fac.Bl.reshape(B, 72),
        fac.BDinv.reshape(B, 72), fac.Sinv.reshape(B, 36)],
        dim=-1).t().contiguous()


def comps_to_factor(fac_p) -> MassFactor:
    flat = fac_p.t()
    B = flat.shape[0]
    return MassFactor(
        Dinv=flat[:, 0:36].reshape(B, 4, 3, 3),
        Bl=flat[:, 36:108].reshape(B, 4, 6, 3),
        BDinv=flat[:, 108:180].reshape(B, 4, 6, 3),
        Sinv=flat[:, 180:216].reshape(B, 6, 6))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _xform_inertia(E, r, m, h, J):
    """Express the spatial inertia (m, h, J) of a child frame in the parent
    frame; the child axes are E (parent->child) and the child origin sits at
    ``r`` in parent coords (Featherstone X^T I X)."""
    Et = E.transpose(-1, -2)
    h_r = (Et @ h[..., None])[..., 0]
    J_r = Et @ J @ E
    h_p = h_r + m[..., None] * r
    rhat, hhat = skew(r), skew(h_r)
    corr = (m[..., None, None] * (rhat @ rhat)
            + (rhat @ hhat + hhat @ rhat))
    return h_p, J_r - corr


def _force_up(E, r, fw, fv):
    """Child->parent force transform."""
    Et = E.transpose(-1, -2)
    fv_p = (Et @ fv[..., None])[..., 0]
    fw_p = (Et @ fw[..., None])[..., 0] + torch.linalg.cross(
        r.expand(fv_p.shape), fv_p)
    return fw_p, fv_p


def _cholesky_inverse6(S):
    """Sinv = L^-T L^-1 from the unrolled Cholesky S = L L^T of a batched
    6x6 (S is SPD: the base block of M after eliminating the leg blocks).
    A non-positive pivot gives NaNs, never an exception."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        d = S[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        Ljj = torch.sqrt(d)
        inv_Ljj = 1.0 / Ljj
        L[j][j] = Ljj
        for i in range(j + 1, 6):
            v = S[..., i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v * inv_Ljj
    Y = [[None] * 6 for _ in range(6)]  # Y = L^-1 (lower)
    for j in range(6):
        Y[j][j] = 1.0 / L[j][j]
    for j in range(6):
        for i in range(j + 1, 6):
            acc = L[i][j] * Y[j][j]
            for k in range(j + 1, i):
                acc = acc + L[i][k] * Y[k][j]
            Y[i][j] = -(acc * Y[i][i])
    rows = []
    for i in range(6):
        row = []
        for j in range(6):
            lo, hi = min(i, j), max(i, j)
            acc = Y[hi][lo] * Y[hi][hi]
            for k in range(hi + 1, 6):
                acc = acc + Y[k][lo] * Y[k][hi]
            row.append(acc)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def build_factor_plain(consts: SubstepConsts, model: WholeBodyModel,
                       q) -> MassFactor:
    """Composite-rigid-body assembly of the tree-sparse mass-matrix blocks +
    the Schur prefactor, from q (..., 4, 3). Equals
    ``prefactor_mass_matrix(mass_matrix(...))`` in exact arithmetic; differs
    by round-off (composite inertias and a Cholesky 6x6 inverse against
    unit-acceleration RNEA columns and an LU inverse)."""
    kw = dict(dtype=q.dtype, device=q.device)
    batch = tuple(q.shape[:-2])
    kin = precompute_leg_kinematics(model, q)
    Es, rs = kin.E, kin.r
    link_m = torch.as_tensor(consts.link_m, **kw)
    leaf_h = torch.as_tensor(consts.leaf_h, **kw)
    leaf_J = torch.as_tensor(consts.leaf_J, **kw)
    arm = torch.as_tensor(consts.armature, **kw)

    # Composite inertias up the chain (frame j), all legs at once.
    m_c = [None, None, link_m[:, 2]]
    h_c = [None, None, leaf_h[:, 2].expand(batch + (4, 3))]
    J_c = [None, None, leaf_J[:, 2].expand(batch + (4, 3, 3))]
    for j in (1, 0):
        h_up, J_up = _xform_inertia(Es[j + 1], rs[j + 1], m_c[j + 1],
                                    h_c[j + 1], J_c[j + 1])
        m_c[j] = link_m[:, j] + m_c[j + 1]
        h_c[j] = leaf_h[:, j] + h_up
        J_c[j] = leaf_J[:, j] + J_up
    h_b, J_b = _xform_inertia(Es[0], rs[0], m_c[0], h_c[0], J_c[0])
    m_tot = consts.trunk_m + float(np.sum(consts.link_m))
    h_tot = h_b.sum(-2)
    J_tot = torch.diag(torch.as_tensor(consts.trunk_I, **kw)) + J_b.sum(-3)

    # F_j = I^c_j S_j propagated toward the base: D and Bl entries.
    D = [[None] * 3 for _ in range(3)]
    Bl_cols = []
    for j in range(3):
        ax = 0 if j == 0 else 1  # abad: x, thigh/knee: y
        h, J = h_c[j], J_c[j]
        fw = J[..., :, ax]
        zero = torch.zeros_like(h[..., 0])
        fv = (torch.stack([zero, -h[..., 2], h[..., 1]], dim=-1) if ax == 0
              else torch.stack([h[..., 2], zero, -h[..., 0]], dim=-1))
        D[j][j] = fw[..., ax] + arm[:, j]
        for i in range(j - 1, -1, -1):
            fw, fv = _force_up(Es[i + 1], rs[i + 1], fw, fv)
            D[i][j] = D[j][i] = fw[..., 0 if i == 0 else 1]
        fw, fv = _force_up(Es[0], rs[0], fw, fv)
        Bl_cols.append(torch.cat([fw, fv], dim=-1))  # (..., 4, 6)
    Bl = torch.stack(Bl_cols, dim=-1)  # (..., 4, 6, 3)
    Dm = torch.stack([torch.stack(D[i], dim=-1) for i in range(3)], dim=-2)

    hhat = skew(h_tot)
    eye3 = torch.eye(3, **kw)
    A = torch.cat([
        torch.cat([J_tot, hhat], dim=-1),
        torch.cat([hhat.transpose(-1, -2), (m_tot * eye3).expand(
            hhat.shape)], dim=-1)], dim=-2)

    Dinv = _inv3(Dm)
    BDinv = Bl @ Dinv
    S = A - torch.einsum("...lij,...lkj->...ik", BDinv, Bl)
    return MassFactor(Dinv=Dinv, Bl=Bl, BDinv=BDinv,
                      Sinv=_cholesky_inverse6(S))


def torque_map_plain(consts: SubstepConsts, model, cfg, R, q, f_world,
                     tau_swing, stance):
    """Commander steps 9b-10: world GRFs -> body-frame forces -> tau = J^T f
    per stance leg, merged with the swing PD torques, optional leg gravity
    compensation, clamped to the torque limits. ``f_world`` (..., 12),
    ``tau_swing`` (..., 4, 3), ``stance`` (..., 4) float or bool."""
    in_st = stance > 0.5 if stance.dtype.is_floating_point else stance
    f_b = forces_to_body_frame(f_world, R, torch.ones_like(in_st))
    tau_st = jacobian_transpose_control(q, f_b, cfg.kinematics)
    tau = torch.where(in_st[..., None], tau_st, tau_swing)
    if consts.gravity_comp:
        tau = tau + leg_gravity_torques(model, q, R)
    return torch.clamp(tau, consts.tau_min, consts.tau_max)


def substeps_plain(consts, model, cfg, contact, state: WholeBodyState,
                   tau, factor: MassFactor, h: float, n_substeps: int):
    """The substep loop with the tick's factor held (sim/plant.substep)."""
    tau_flat = tau.reshape(tau.shape[:-2] + (12,))
    for _ in range(n_substeps):
        state = _plant.substep(state, tau_flat, h, model, cfg, contact,
                               factor=factor)
    return state


# ---------------------------------------------------------------------------
# The stepper
# ---------------------------------------------------------------------------

def make_fused_stepper(model: WholeBodyModel, cfg: ControlConfig,
                       contact: ContactConfig = ContactConfig(),
                       rows=None, prefactor: str = "kernel",
                       torque_input: str = "tau",
                       gravity_comp: bool = False):
    """Build the fused plant stepper.

    Model/geometry/contact parameters are snapshot to floats HERE and handed
    to the kernel as runtime arguments.

    ``prefactor``: where the once-per-tick mass-matrix factor comes from.
      - ``"kernel"`` (default): composite-rigid-body assembly + Schur
        prefactor + Cholesky 6x6 inverse inside the kernel, from q.
      - ``"xla"`` (the reference's name for "outside the kernel"): computed
        by ``sim.dynamics.prefactor_mass_matrix`` in PyTorch and streamed in
        as a (216, B) tensor — matches ``whole_body_step(m_update="tick")``.

    ``torque_input``:
      - ``"tau"``: ``stepper(state, tau, dt, n_substeps)``.
      - ``"qp"``: ``stepper(state, f_world, tau_swing, stance, dt,
        n_substeps)`` — the torque map runs as the kernel's prologue. Also
        ``stepper.packed(state_p, fw_p, tausw_p, st_p, dt, n_substeps)`` on
        ``(k, B)`` tensors for the fused tick loop (sim/fused_tick.py).

    ``gravity_comp`` (``"qp"`` only): add the kernel's equivalent of
    ``sim.dynamics.leg_gravity_torques`` before clamping.

    The tensors' device decides the path: CUDA launches the kernel (counted
    in ``kernels.launch_counts["qct_substep"]``), CPU runs the plain version.
    ``rows`` is ignored (a tile height of the TPU kernel). Also exposed:
    ``stepper.plain(state_p, *extras, dt, n_substeps)`` (the plain version on
    any device), ``stepper.build_factor(q)`` and ``stepper.torque_map(...)``
    (the plain versions of the two prologues), ``stepper.streamed(state_p)``
    (the (216, B) factor the kernel is given, None with ``prefactor=
    "kernel"``) and ``stepper.consts``.
    """
    if prefactor not in ("kernel", "xla"):
        raise ValueError(f"prefactor must be 'kernel'|'xla': {prefactor}")
    if torque_input not in ("tau", "qp"):
        raise ValueError(f"torque_input must be 'tau'|'qp': {torque_input}")
    if gravity_comp and torque_input != "qp":
        raise ValueError("gravity_comp requires torque_input='qp'")
    if contact.tangential not in ("anchor", "coulomb"):
        raise ValueError(
            f"tangential must be 'anchor'|'coulomb': {contact.tangential}")
    consts = _snapshot(model, cfg, contact, prefactor, torque_input,
                       gravity_comp)
    params = kernels.substep_params(consts)

    def build_factor(q):
        return build_factor_plain(consts, model, q)

    def streamed_factor(q):
        kin = precompute_leg_kinematics(model, q)
        return prefactor_mass_matrix(
            mass_matrix(model, kin, q.shape[:-2], q.dtype))

    def torque_map(R, q, f_world, tau_swing, stance):
        return torque_map_plain(consts, model, cfg, R, q, f_world,
                                tau_swing, stance)

    def check_state(state_p):
        if state_p.dim() != 2 or state_p.shape[0] != N_STATE:
            raise ValueError(f"state: expected ({N_STATE}, B), got "
                             f"{tuple(state_p.shape)}")

    def streamed(state_p):
        if prefactor != "xla":
            return None
        q = state_p[30:42].t().reshape(-1, 4, 3)
        return factor_to_comps(streamed_factor(q))

    def plain(state_p, *extras_and_step):
        """The plain PyTorch version of the kernel, on ``(k, B)`` tensors of
        any dtype on any device: ``plain(state_p, *extras, dt,
        n_substeps)`` with ``extras`` = (tau,) or (fw, tau_swing, st)."""
        *extras, dt, n_substeps = extras_and_step
        check_state(state_p)
        h = float(dt) / int(n_substeps)
        state = comps_to_state(state_p)
        B = state.x.shape[0]
        if torque_input == "qp":
            fw, tausw, st = extras
            tau = torque_map(state.R, state.q, fw.t(),
                             tausw.t().reshape(B, 4, 3), st.t())
        else:
            tau = extras[0].t().reshape(B, 4, 3)
        fac_p = streamed(state_p)
        fac = (build_factor(state.q) if fac_p is None
               else comps_to_factor(fac_p))
        return state_to_comps(substeps_plain(
            consts, model, cfg, contact, state, tau, fac, h,
            int(n_substeps)))

    def run_packed(state_p, extras, dt, n_substeps):
        """``extras``: (tau,) or (fw, tau_swing, st), each (k, B)."""
        if state_p.device.type == "cpu":
            return plain(state_p, *extras, dt, n_substeps)
        check_state(state_p)
        return kernels.substep(state_p, extras, streamed(state_p), params,
                               int(n_substeps), float(dt) / int(n_substeps))

    def run(state: WholeBodyState, extra, widths, dt, n_substeps):
        batch = tuple(state.x.shape[:-1])
        dtype = state.x.dtype
        flat = WholeBodyState(
            R=state.R.reshape(-1, 3, 3), x=state.x.reshape(-1, 3),
            u=state.u.reshape(-1, 18), q=state.q.reshape(-1, 4, 3),
            anchor=state.anchor.reshape(-1, 8, 2))
        B = flat.x.shape[0]
        extras = tuple(
            torch.as_tensor(e, device=state.x.device).to(dtype).expand(
                batch + shape).reshape(B, -1).t().contiguous()
            for e, shape in zip(extra, widths))
        out = comps_to_state(run_packed(state_to_comps(flat), extras, dt,
                                        n_substeps))
        return WholeBodyState(
            R=out.R.reshape(batch + (3, 3)), x=out.x.reshape(batch + (3,)),
            u=out.u.reshape(batch + (18,)), q=out.q.reshape(batch + (4, 3)),
            anchor=out.anchor.reshape(batch + (8, 2)))

    if torque_input == "tau":
        def stepper(state: WholeBodyState, tau, dt: float, n_substeps: int):
            return run(state, (tau,), ((4, 3),), dt, n_substeps)

        def packed(state_p, tau_p, dt: float, n_substeps: int):
            return run_packed(state_p, (tau_p,), dt, n_substeps)
    else:
        def stepper(state: WholeBodyState, f_world, tau_swing, stance,
                    dt: float, n_substeps: int):
            return run(state, (f_world, tau_swing, stance),
                       ((12,), (4, 3), (4,)), dt, n_substeps)

        def packed(state_p, fw_p, tausw_p, st_p, dt: float, n_substeps: int):
            return run_packed(state_p, (fw_p, tausw_p, st_p), dt, n_substeps)

    stepper.packed = packed
    stepper.plain = plain
    stepper.streamed = streamed
    stepper.build_factor = build_factor
    stepper.torque_map = torque_map
    stepper.consts = consts
    return stepper
