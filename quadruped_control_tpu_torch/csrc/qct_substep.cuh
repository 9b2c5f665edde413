// K5: N physics substeps of the whole-body plant, one robot per group of
// QS_G lanes (8 unless the build says otherwise), the tick's factor, state
// and scratch in shared memory.
//
// Replaces the TPU kernel body of
// quadruped_control_tpu/sim/pallas_substep.py (make_pallas_stepper(...).kernel,
// with torque_map_sym, build_factor_sym and rnea_legs): the torque-map
// prologue, the once-per-tick mass-matrix factor (composite-rigid-body
// assembly + Schur prefactor + Cholesky 6x6 inverse, or a streamed factor),
// then n_substeps x (RNEA bias, 8-point compliant contact, prefactored tree
// solve, semi-implicit step, Rodrigues, velocity clamp, freeze-on-nonfinite).
//
// The model, the contact parameters and the torque limits are RUNTIME
// arguments (QctSubParams), as are n_substeps and h: both model presets,
// every contact configuration and the four prefactor x torque_input
// combinations run on one compiled kernel. The TPU version folds the model's
// exact zeros away while tracing; here the 13-body tree is two loops (legs,
// joints) over general 3-vectors.
//
// Two bodies. substep_instance_serial runs one robot in one thread (the
// kernel's first form, kept as the reference: the host shim's
// host_substep_serial and the card's qct_substep_serial, which only
// chip_smoke.py's hold launches). substep_lanes is the kernel's: a group of
// QS_G lanes per robot. Both call the same per-leg, per-point and per-row
// pieces (qs_rnea_leg, qs_factor_leg, qs_contact, qs_rb_row, ...), and every
// element keeps the serial body's operation order, so the two are bitwise
// equal.
//
// Lanes. A lane section (QS_PHASE) runs its body in each lane and ends with
// a sync of the warp. QS_ITEMS deals a section's work items to the lanes: a
// leg's RNEA sweep or joint accelerations, a contact point, a row of the
// Schur solve, an element of S, of Sinv or of the new state. Every lane runs
// the same rounds of the same code, a lane past the item count on a copy
// whose stores it skips, so that a section is one stream of code in which
// independent items (a leg's RNEA sweep and a contact point) interleave and
// no branch depends on the lane. Everything a section passes on goes through
// the robot's QSShared. Rules that keep the bits: a lane never reads what
// another lane wrote since the last sync; a sum over legs, points or the
// state's 58 words is formed in the serial order by one lane (the per-leg
// and per-point terms are gathered in shared memory first); a value several
// lanes need they each compute, by the same statements, rather than wait
// for it (the trunk's bias, the six base accelerations, the guard's sum).
// The syncs name the whole warp (full-mask __syncwarp), and the sections'
// loops and branches depend only on the launch's uniform arguments: the
// QS_G-lane groups of a warp meet at every sync, a frozen robot runs along
// (its guard only selects what it writes), and a slot past B runs on robot
// B - 1 and writes nothing.
//
// Host build (QCT_DEV = static inline): a lane section is a loop of the
// lanes over its body, in the order QS_HOST_LANES gives (ascending unless the
// includer defines it otherwise), and the syncs are empty. An includer that
// defines QS_WARP_SYNC() gets the card's form instead (one lane per call of
// the body, g.lane): the test shim (tests/torch_port_host_shim.cpp) runs a
// warp's lanes as coroutines from sync to sync (tests/
// test_torch_substep_lanes.py).
//
// NaN handling decides the guard: the velocity clamp must pass a NaN through
// (qclamp, like torch.clamp) so that the |.|-sum of the new state is NaN,
// "sum < 1e30" is false and the robot freezes. fminf/fmaxf would turn the
// NaN into +-200 and let a poisoned robot run on.
#pragma once

#include "qct_vec.cuh"

#define QS_N_STATE 58
#define QS_N_FACTOR 216

// Lanes per robot (4, 8 or 16) and K5's __launch_bounds__ (blocks of 128
// threads, 4 of them an SM at <= 128 registers). Other widths build with
// -DQS_G (scripts/torch_substep_widths.py times them).
#ifndef QS_G
#define QS_G 8
#endif
#ifndef QS_MAX_THREADS
#define QS_MAX_THREADS 128
#define QS_MIN_BLOCKS 4
#endif
static_assert(QS_G == 4 || QS_G == 8 || QS_G == 16,
              "a robot runs on 4, 8 or 16 lanes");

// Runtime constants (mirrored by kernels.SubstepParams, same order).
struct QctSubParams {
  float trunk_m;
  float trunk_I[3];    // diagonal
  float link_m[12];    // [leg][joint]
  float link_c[36];    // [leg][joint][xyz] COM in link frame
  float link_I[36];    // [leg][joint] diagonal, about the COM
  float leaf_h[36];    // m * c
  float leaf_J[108];   // [leg][joint] 3x3 inertia about the link origin
  float joint_r[36];   // [leg][joint][xyz] joint origin in parent coords
  float damp[12];
  float armature[12];
  float hips[12];      // [leg][xyz]
  float l1s[4];
  float sl2, sl3;
  float k_n, d_n, mu, kt, ct, v_s, trunk_cz;
  float tau_min, tau_max, gravity;
  int use_anchor;        // 1 anchor stiction, 0 regularized Coulomb
  int torque_qp;         // 1: (fw, tau_swing, st) prologue; 0: tau given
  int gravity_comp;      // add leg gravity torques in the prologue
  int prefactor_kernel;  // 1: factor built here; 0: streamed in
};

struct QctSubIO {
  const float* state;   // (58, B)
  const float* a;       // (12, B): world GRFs (qp) or joint torques (tau)
  const float* tau_sw;  // (12, B), qp only
  const float* st;      // (4, B), qp only
  const float* factor;  // (216, B), streamed factor only
  float* out;           // (58, B)
};

// The tick's factor: per-leg Dinv (3x3), Bl (6x3), BDinv (6x3), Sinv (6x6).
struct QctFactor {
  float Dinv[36];
  float Bl[72];
  float BDinv[72];
  float Sinv[36];
};

// E v with E = R_axis(q)^T (parent coords -> child coords); transpose
// applies E^T. jtype 0 = x axis, 1 = y axis. o must not alias v.
QCT_DEV void qs_rot(int jtype, float s, float c, const float* v, float* o,
                    bool transpose) {
  const float sn = transpose ? s : -s;
  if (jtype == 0) {
    o[0] = v[0];
    o[1] = c * v[1] - sn * v[2];
    o[2] = sn * v[1] + c * v[2];
  } else {
    o[0] = c * v[0] + sn * v[2];
    o[1] = v[1];
    o[2] = c * v[2] - sn * v[0];
  }
}

// (h_ang, h_lin) of the spatial inertia about the link-frame origin applied
// to a motion vector (w, v): diagonal Ic about the COM at cv.
QCT_DEV void qs_inertia_apply(const float* Ic, float m, const float* cv,
                              const float* w, const float* v, float* h_ang,
                              float* h_lin) {
  float cxw[3], wxc[3], cxwxc[3], cxv[3];
  v3_cross(cxw, cv, w);
  v3_scale(wxc, -1.0f, cxw);
  v3_cross(cxwxc, cv, wxc);
  v3_cross(cxv, cv, v);
  for (int k = 0; k < 3; ++k) {
    h_ang[k] = Ic[k] * w[k] + m * cxwxc[k] + m * cxv[k];
    h_lin[k] = m * (v[k] - cxw[k]);
  }
}

// g_base = gravity * (third row of R): the base acceleration of the gravity
// trick.
QCT_DEV void qs_gravity_base(const QctSubParams& P, const float* R,
                             float* g_base) {
  for (int k = 0; k < 3; ++k) g_base[k] = P.gravity * R[6 + k];
}

// RNEA sweep of one leg at zero joint acceleration and base acceleration
// g_base (the gravity trick). Writes the three joint bias torques and the
// leg's wrench on the base, wrench = (fw_c | fv_c), which the caller adds
// to the trunk's in leg order.
QCT_DEV void qs_rnea_leg(const QctSubParams& P, int leg, const float* s,
                         const float* c, const float* w_b, const float* v_b,
                         const float* qd, const float* g_base, float* bias_q,
                         float* wrench) {
  float w_p[3], v_p[3], aw_p[3] = {0.0f, 0.0f, 0.0f}, av_p[3];
  float fw[9], fv[9];
  v3_copy(w_p, w_b);
  v3_copy(v_p, v_b);
  v3_copy(av_p, g_base);
  for (int j = 0; j < 3; ++j) {
    const int jtype = j == 0 ? 0 : 1;
    const int lj = 3 * leg + j;
    const float* r = P.joint_r + 3 * lj;
    float t1[3], t2[3], w_j[3], v_j[3], aw_j[3], av_j[3];
    v3_cross(t1, r, w_p);
    v3_sub(t2, v_p, t1);
    qs_rot(jtype, s[j], c[j], w_p, w_j, false);
    qs_rot(jtype, s[j], c[j], t2, v_j, false);
    v3_cross(t1, r, aw_p);
    v3_sub(t2, av_p, t1);
    qs_rot(jtype, s[j], c[j], aw_p, aw_j, false);
    qs_rot(jtype, s[j], c[j], t2, av_j, false);

    float wJ[3] = {0.0f, 0.0f, 0.0f};
    wJ[jtype] = qd[j];
    w_j[jtype] = w_j[jtype] + qd[j];  // w_new
    v3_cross(t1, w_j, wJ);
    v3_add(aw_j, aw_j, t1);
    v3_cross(t1, v_j, wJ);
    v3_add(av_j, av_j, t1);

    const float m = P.link_m[lj];
    const float* cv = P.link_c + 3 * lj;
    const float* Ic = P.link_I + 3 * lj;
    float hw[3], hv[3], fw_a[3], fv_a[3], c1[3], c2[3];
    qs_inertia_apply(Ic, m, cv, w_j, v_j, hw, hv);
    qs_inertia_apply(Ic, m, cv, aw_j, av_j, fw_a, fv_a);
    v3_cross(c1, w_j, hw);
    v3_cross(c2, v_j, hv);
    for (int k = 0; k < 3; ++k) fw[3 * j + k] = fw_a[k] + c1[k] + c2[k];
    v3_cross(c1, w_j, hv);
    for (int k = 0; k < 3; ++k) fv[3 * j + k] = fv_a[k] + c1[k];
    v3_copy(w_p, w_j);
    v3_copy(v_p, v_j);
    v3_copy(aw_p, aw_j);
    v3_copy(av_p, av_j);
  }
  float fw_c[3] = {0.0f, 0.0f, 0.0f}, fv_c[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 2; j >= 0; --j) {
    const int jtype = j == 0 ? 0 : 1;
    const float* r = P.joint_r + 3 * (3 * leg + j);
    float fw_t[3], fv_t[3], EtFv[3], EtFw[3], rx[3];
    v3_add(fw_t, fw + 3 * j, fw_c);
    v3_add(fv_t, fv + 3 * j, fv_c);
    bias_q[j] = fw_t[jtype];
    qs_rot(jtype, s[j], c[j], fv_t, EtFv, true);
    qs_rot(jtype, s[j], c[j], fw_t, EtFw, true);
    v3_cross(rx, r, EtFv);
    v3_add(fw_c, EtFw, rx);
    v3_copy(fv_c, EtFv);
  }
  v3_copy(wrench, fw_c);
  v3_copy(wrench + 3, fv_c);
}

// The trunk's own bias wrench (f0w, f0v), before the legs' are added.
QCT_DEV void qs_trunk_bias(const QctSubParams& P, const float* st,
                           float* f0w, float* f0v) {
  const float* w_b = st + 12;
  const float* v_b = st + 15;
  float g_base[3], t1[3], t2[3];
  qs_gravity_base(P, st, g_base);
  for (int k = 0; k < 3; ++k) t1[k] = P.trunk_I[k] * w_b[k];
  v3_cross(f0w, w_b, t1);
  v3_scale(t1, P.trunk_m, v_b);
  v3_cross(t2, w_b, t1);
  for (int k = 0; k < 3; ++k) f0v[k] = P.trunk_m * g_base[k] + t2[k];
}

// Joint rotation E (parent -> child) as a row-major matrix.
QCT_DEV void qs_joint_E(int jtype, float s, float c, float* E) {
  for (int k = 0; k < 9; ++k) E[k] = 0.0f;
  if (jtype == 0) {
    E[0] = 1.0f;
    E[4] = c;
    E[5] = s;
    E[7] = -s;
    E[8] = c;
  } else {
    E[0] = c;
    E[2] = -s;
    E[4] = 1.0f;
    E[6] = s;
    E[8] = c;
  }
}

// Express the spatial inertia (m, h, J) of a child frame in the parent frame
// (child axes E, child origin r in parent coords): Featherstone X^T I X.
QCT_DEV void qs_xform_inertia(const float* E, const float* r, float m,
                              const float* h, const float* J, float* h_p,
                              float* J_p) {
  float h_r[3], EtJ[9], J_r[9], rhat[9], hhat[9], rr[9], rh[9], hr[9];
  m3_mtv(h_r, E, h);
  m3_tmul(EtJ, E, J);
  m3_mul(J_r, EtJ, E);
  for (int k = 0; k < 3; ++k) h_p[k] = h_r[k] + m * r[k];
  m3_skew(rhat, r);
  m3_skew(hhat, h_r);
  m3_mul(rr, rhat, rhat);
  m3_mul(rh, rhat, hhat);
  m3_mul(hr, hhat, rhat);
  for (int k = 0; k < 9; ++k) J_p[k] = J_r[k] - (m * rr[k] + (rh[k] + hr[k]));
}

// Child -> parent force transform (in place).
QCT_DEV void qs_force_up(const float* E, const float* r, float* fw,
                         float* fv) {
  float fv_p[3], fw_p[3], rx[3];
  m3_mtv(fv_p, E, fv);
  m3_mtv(fw_p, E, fw);
  v3_cross(rx, r, fv_p);
  v3_add(fw, fw_p, rx);
  v3_copy(fv, fv_p);
}

// One leg's part of the factor (sim/fused_substep.py::build_factor_plain)
// from the tick-start sines/cosines of q: its composite inertias up the
// chain, its Dinv, Bl and BDinv blocks (into F), and its composite inertia
// expressed at the base, tot = [m | h (3) | J (9)], which qs_tree_totals
// adds to the trunk's in leg order.
QCT_DEV void qs_factor_leg(const QctSubParams& P, int leg, const float* sn,
                           const float* cs, QctFactor& F, float* tot) {
  float E[27], mc[3], hc[9], Jc[27];
  for (int j = 0; j < 3; ++j)
    qs_joint_E(j == 0 ? 0 : 1, sn[3 * leg + j], cs[3 * leg + j], E + 9 * j);
  // Composite inertias up the chain (frame j).
  mc[2] = P.link_m[3 * leg + 2];
  v3_copy(hc + 6, P.leaf_h + 3 * (3 * leg + 2));
  for (int k = 0; k < 9; ++k) Jc[18 + k] = P.leaf_J[9 * (3 * leg + 2) + k];
  for (int j = 1; j >= 0; --j) {
    const int lj = 3 * leg + j;
    float h_up[3], J_up[9];
    qs_xform_inertia(E + 9 * (j + 1), P.joint_r + 3 * (lj + 1), mc[j + 1],
                     hc + 3 * (j + 1), Jc + 9 * (j + 1), h_up, J_up);
    mc[j] = P.link_m[lj] + mc[j + 1];
    for (int k = 0; k < 3; ++k) hc[3 * j + k] = P.leaf_h[3 * lj + k] + h_up[k];
    for (int k = 0; k < 9; ++k) Jc[9 * j + k] = P.leaf_J[9 * lj + k] + J_up[k];
  }
  tot[0] = mc[0];
  qs_xform_inertia(E, P.joint_r + 9 * leg, mc[0], hc, Jc, tot + 1, tot + 4);
  // F_j = I^c_j S_j propagated toward the base: D and Bl entries.
  float D[9];
  float* Bl = F.Bl + 18 * leg;
  for (int j = 0; j < 3; ++j) {
    const int ax = j == 0 ? 0 : 1;
    const float* h = hc + 3 * j;
    const float* J = Jc + 9 * j;
    float fw[3] = {J[ax], J[3 + ax], J[6 + ax]};
    float fv[3];
    if (ax == 0)
      v3_set(fv, 0.0f, -h[2], h[1]);
    else
      v3_set(fv, h[2], 0.0f, -h[0]);
    D[4 * j] = fw[ax] + P.armature[3 * leg + j];
    for (int i = j - 1; i >= 0; --i) {
      qs_force_up(E + 9 * (i + 1), P.joint_r + 3 * (3 * leg + i + 1), fw, fv);
      const float d = fw[i == 0 ? 0 : 1];
      D[3 * i + j] = d;
      D[3 * j + i] = d;
    }
    qs_force_up(E, P.joint_r + 9 * leg, fw, fv);
    for (int r = 0; r < 3; ++r) {
      Bl[3 * r + j] = fw[r];
      Bl[3 * (3 + r) + j] = fv[r];
    }
  }
  // Dinv = adj(D) / det(D); BDinv = Bl Dinv.
  float adj[9], det;
  float* Dinv = F.Dinv + 9 * leg;
  float* BDinv = F.BDinv + 18 * leg;
  m3_adj(D, adj, det);
  for (int k = 0; k < 9; ++k) Dinv[k] = adj[k] / det;
  for (int r = 0; r < 6; ++r)
    for (int cc = 0; cc < 3; ++cc)
      BDinv[3 * r + cc] = Bl[3 * r] * Dinv[cc] + Bl[3 * r + 1] * Dinv[3 + cc] +
                          Bl[3 * r + 2] * Dinv[6 + cc];
}

// The whole tree's composite inertia at the base: the trunk's plus the
// legs' (tot of qs_factor_leg, 13 words a leg), in leg order.
QCT_DEV void qs_tree_totals(const QctSubParams& P, const float* tot,
                            float& m_tot, float* h_tot, float* J_tot) {
  m_tot = P.trunk_m;
  v3_set(h_tot, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 9; ++k) J_tot[k] = 0.0f;
  for (int k = 0; k < 3; ++k) J_tot[4 * k] = P.trunk_I[k];
  for (int leg = 0; leg < 4; ++leg) {
    const float* t = tot + 13 * leg;
    m_tot = m_tot + t[0];
    v3_add(h_tot, h_tot, t + 1);
    for (int k = 0; k < 9; ++k) J_tot[k] = J_tot[k] + t[4 + k];
  }
}

// Entry (i, j) of the Schur complement S = A - sum_leg BDinv_leg Bl_leg^T
// with A = [[J, h^], [h^T, m I]].
QCT_DEV float qs_schur_entry(const QctFactor& F, int i, int j, float m_tot,
                             const float* h_tot, const float* J_tot) {
  float hhat[9];
  m3_skew(hhat, h_tot);
  float s;
  if (i < 3)
    s = j < 3 ? J_tot[3 * i + j] : hhat[3 * i + j - 3];
  else
    s = j < 3 ? hhat[3 * j + i - 3] : (i == j ? m_tot : 0.0f);
  float acc = 0.0f;
  for (int leg = 0; leg < 4; ++leg)
    for (int t = 0; t < 3; ++t)
      acc = acc + F.BDinv[18 * leg + 3 * i + t] * F.Bl[18 * leg + 3 * j + t];
  return s - acc;
}

// Cholesky S = L L^T and Y = L^-1 (lower triangles; Y's upper part is left
// as it was). A non-positive pivot gives NaNs (sqrtf of a negative), never a
// trap.
QCT_DEV void qs_chol_inv(const float* S, float* Y) {
  float L[36];
  for (int j = 0; j < 6; ++j) {
    float d = S[7 * j];
    for (int k = 0; k < j; ++k) d = d - L[6 * j + k] * L[6 * j + k];
    const float Ljj = sqrtf(d);
    const float inv_Ljj = 1.0f / Ljj;
    L[7 * j] = Ljj;
    for (int i = j + 1; i < 6; ++i) {
      float v = S[6 * i + j];
      for (int k = 0; k < j; ++k) v = v - L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = v * inv_Ljj;
    }
  }
  for (int j = 0; j < 6; ++j) Y[7 * j] = 1.0f / L[7 * j];
  for (int j = 0; j < 6; ++j)
    for (int i = j + 1; i < 6; ++i) {
      float acc = L[6 * i + j] * Y[7 * j];
      for (int k = j + 1; k < i; ++k) acc = acc + L[6 * i + k] * Y[6 * k + j];
      Y[6 * i + j] = -(acc * Y[7 * i]);
    }
}

// Entry (i, j) of Sinv = Y^T Y (the terms k > max(i, j) in k order; a loop
// of fixed length, so that it unrolls for a lane's runtime (i, j)).
QCT_DEV float qs_sinv_entry(const float* Y, int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  float acc = Y[6 * hi + lo] * Y[7 * hi];
  for (int k = 1; k < 6; ++k)
    if (k > hi) acc = acc + Y[6 * k + lo] * Y[6 * k + hi];
  return acc;
}

// Contact point p (0-3 the feet, 4-7 the trunk corners) of the 58-word
// state st with the sines/cosines of its q: the new tangential anchor
// (anchor2), the point's moment and force on the base in base coordinates
// (pxf, f_b), and for a foot its leg's joint torques J^T f_b (g_q3).
QCT_DEV void qs_contact(const QctSubParams& P, int p, const float* sn,
                        const float* cs, const float* st, float* anchor2,
                        float* pxf, float* f_b, float* g_q3) {
  const float* R = st;
  const float* x = st + 9;
  const float* w_b = st + 12;
  const float* v_b = st + 15;
  const float* qd = st + 18;
  const float* anchor = st + 42;
  const int leg = p & 3;
  float pt_b[3], Jl[9], v_pt[3];
  if (p < 4) {
    const float s2 = sn[3 * leg + 1], c2 = cs[3 * leg + 1];
    const float s3 = sn[3 * leg + 2], c3 = cs[3 * leg + 2];
    leg_fk_jac(sn[3 * leg], cs[3 * leg], s2, c2, s2 * c3 + c2 * s3,
               c2 * c3 - s2 * s3, P.l1s[leg], P.sl2, P.sl3, P.hips + 3 * leg,
               pt_b, Jl);
    m3_mv(v_pt, Jl, qd + 3 * leg);
  } else {
    v3_set(pt_b, P.hips[3 * leg], P.hips[3 * leg + 1],
           P.hips[3 * leg + 2] + P.trunk_cz);
    v3_set(v_pt, 0.0f, 0.0f, 0.0f);
  }
  float p_w[3], v_w[3], wxp[3];
  m3_mv(p_w, R, pt_b);
  v3_add(p_w, p_w, x);
  v3_cross(wxp, w_b, pt_b);
  for (int k = 0; k < 3; ++k) v_pt[k] = v_b[k] + wxp[k] + v_pt[k];
  m3_mv(v_w, R, v_pt);

  const float phi = -p_w[2];
  const float phidot = -v_w[2];
  const bool in_contact = phi > 0.0f;
  float fn = P.k_n * phi * (1.0f + P.d_n * phidot);
  fn = in_contact ? qmax(fn, 0.0f) : 0.0f;
  float ftx, fty;
  if (P.use_anchor) {
    const float rx = -P.kt * (p_w[0] - anchor[2 * p]) - P.ct * v_w[0];
    const float ry = -P.kt * (p_w[1] - anchor[2 * p + 1]) - P.ct * v_w[1];
    const float ftn = sqrtf(rx * rx + ry * ry + 1e-16f);
    const float scale = qmin(P.mu * fn / ftn, 1.0f);
    ftx = in_contact ? scale * rx : 0.0f;
    fty = in_contact ? scale * ry : 0.0f;
    anchor2[0] = in_contact ? p_w[0] + (ftx + P.ct * v_w[0]) / P.kt : p_w[0];
    anchor2[1] = in_contact ? p_w[1] + (fty + P.ct * v_w[1]) / P.kt : p_w[1];
  } else {
    const float speed = sqrtf(v_w[0] * v_w[0] + v_w[1] * v_w[1] + 1e-16f);
    const float scale = P.mu * fn / qmax(speed, P.v_s);
    ftx = -scale * v_w[0];
    fty = -scale * v_w[1];
    anchor2[0] = p_w[0];
    anchor2[1] = p_w[1];
  }
  const float f_w[3] = {ftx, fty, fn};
  m3_mtv(f_b, R, f_w);
  v3_cross(pxf, pt_b, f_b);
  if (p < 4) m3_mtv(g_q3, Jl, f_b);
}

// Joint k's right-hand side: tau - damping + contact - bias.
QCT_DEV float qs_rq(const QctSubParams& P, const float* tau, const float* qd,
                    const float* g_q, const float* bias_q, int k) {
  return tau[k] - P.damp[k] * qd[k] + g_q[k] - bias_q[k];
}

// Base row r of the Schur solve's right-hand side: rb (= contact - bias)
// less BDinv_leg rq_leg, in leg order.
QCT_DEV float qs_rb_row(const QctFactor& F, int r, float rb,
                        const float* rq) {
  for (int leg = 0; leg < 4; ++leg) {
    float acc = 0.0f;
    for (int cc = 0; cc < 3; ++cc)
      acc = acc + F.BDinv[18 * leg + 3 * r + cc] * rq[3 * leg + cc];
    rb = rb - acc;
  }
  return rb;
}

// Base acceleration r: row r of Sinv rb.
QCT_DEV float qs_ub_row(const QctFactor& F, int r, const float* rb) {
  float acc = 0.0f;
  for (int cc = 0; cc < 6; ++cc) acc = acc + F.Sinv[6 * r + cc] * rb[cc];
  return acc;
}

// A leg's joint accelerations: Dinv (rq - Bl^T ub).
QCT_DEV void qs_leg_accel(const QctFactor& F, int leg, const float* rq3,
                          const float* ub, float* qdd) {
  float t[3];
  for (int cc = 0; cc < 3; ++cc) {
    float acc = 0.0f;
    for (int r = 0; r < 6; ++r)
      acc = acc + F.Bl[18 * leg + 3 * r + cc] * ub[r];
    t[cc] = rq3[cc] - acc;
  }
  for (int r = 0; r < 3; ++r)
    qdd[r] = F.Dinv[9 * leg + 3 * r] * t[0] + F.Dinv[9 * leg + 3 * r + 1] * t[1] +
             F.Dinv[9 * leg + 3 * r + 2] * t[2];
}

// One leg of the torque-map prologue: f_b = -R^T f_w, tau = J^T f_b on a
// stance leg, the swing PD torques otherwise, + the leg's gravity torques,
// clamped.
QCT_DEV void qs_torque_leg(const QctSubParams& P, int leg, const float* R,
                           const float* sn, const float* cs, const float* f_w,
                           const float* tau_sw3, float stance_in,
                           float* tau3) {
  float tau_g[3] = {0.0f, 0.0f, 0.0f};
  if (P.gravity_comp) {
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    float g_base[3], sink[6];
    qs_gravity_base(P, R, g_base);
    qs_rnea_leg(P, leg, sn + 3 * leg, cs + 3 * leg, zero3, zero3, zero3,
                g_base, tau_g, sink);
  }
  const bool stance = stance_in > 0.5f;
  float rtf[3], f_b[3], Jl[9], tau_st[3];
  m3_mtv(rtf, R, f_w);
  v3_scale(f_b, -1.0f, rtf);
  const float s2 = sn[3 * leg + 1], c2 = cs[3 * leg + 1];
  const float s3 = sn[3 * leg + 2], c3 = cs[3 * leg + 2];
  leg_fk_jac(sn[3 * leg], cs[3 * leg], s2, c2, s2 * c3 + c2 * s3,
             c2 * c3 - s2 * s3, P.l1s[leg], P.sl2, P.sl3, P.hips + 3 * leg,
             nullptr, Jl);
  m3_mtv(tau_st, Jl, f_b);
  for (int j = 0; j < 3; ++j) {
    float v = stance ? tau_st[j] : tau_sw3[j];
    if (P.gravity_comp) v = v + tau_g[j];
    tau3[j] = qclamp(v, P.tau_min, P.tau_max);
  }
}

// ---------------------------------------------------------------------------
// The serial body: one robot in one thread (the kernel's first form, kept as
// the reference of the lane body).
// ---------------------------------------------------------------------------

// The whole factor from the tick-start sines/cosines of q.
QCT_DEV_NOINLINE void qs_build_factor(const QctSubParams& P, const float* sn,
                                      const float* cs, QctFactor& F) {
  float tot[52];
  for (int leg = 0; leg < 4; ++leg)
    qs_factor_leg(P, leg, sn, cs, F, tot + 13 * leg);
  float m_tot, h_tot[3], J_tot[9];
  qs_tree_totals(P, tot, m_tot, h_tot, J_tot);
  float S[36], Y[36];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      S[6 * i + j] = qs_schur_entry(F, i, j, m_tot, h_tot, J_tot);
  qs_chol_inv(S, Y);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) F.Sinv[6 * i + j] = qs_sinv_entry(Y, i, j);
}

// One substep of length h under joint torques tau, factor F held. st is the
// 58-word state, updated in place (or frozen).
QCT_DEV_NOINLINE void qs_substep(const QctSubParams& P, const QctFactor& F,
                                 const float* tau, float h, float* st) {
  float* R = st;
  float* x = st + 9;
  float* u = st + 12;
  float* q = st + 30;
  float* anchor = st + 42;
  const float* w_b = u;
  const float* v_b = u + 3;
  const float* qd = u + 6;
  float sn[12], cs[12];
  for (int k = 0; k < 12; ++k) {
    sn[k] = sinf(q[k]);
    cs[k] = cosf(q[k]);
  }

  // RNEA bias (zero accelerations; base acceleration = gravity trick).
  float g_base[3], f0w[3], f0v[3], bias_q[12], wrench[6];
  qs_gravity_base(P, R, g_base);
  qs_trunk_bias(P, st, f0w, f0v);
  for (int leg = 0; leg < 4; ++leg) {
    qs_rnea_leg(P, leg, sn + 3 * leg, cs + 3 * leg, w_b, v_b, qd + 3 * leg,
                g_base, bias_q + 3 * leg, wrench);
    v3_add(f0w, f0w, wrench);
    v3_add(f0v, f0v, wrench + 3);
  }

  // Contact: 4 feet, then 4 trunk corners.
  float g_w[3] = {0.0f, 0.0f, 0.0f}, g_v[3] = {0.0f, 0.0f, 0.0f};
  float g_q[12], anchor_new[16], pf[6];
  for (int p = 0; p < 8; ++p) {
    qs_contact(P, p, sn, cs, st, anchor_new + 2 * p, pf, pf + 3,
               g_q + 3 * (p & 3));
    v3_add(g_w, g_w, pf);
    v3_add(g_v, g_v, pf + 3);
  }

  // Solve M udot = rhs with the prefactored Schur form.
  float rb[6], rq[12], ub[6], udot[18];
  for (int k = 0; k < 3; ++k) {
    rb[k] = g_w[k] - f0w[k];
    rb[3 + k] = g_v[k] - f0v[k];
  }
  for (int k = 0; k < 12; ++k) rq[k] = qs_rq(P, tau, qd, g_q, bias_q, k);
  for (int r = 0; r < 6; ++r) rb[r] = qs_rb_row(F, r, rb[r], rq);
  for (int r = 0; r < 6; ++r) {
    ub[r] = qs_ub_row(F, r, rb);
    udot[r] = ub[r];
  }
  for (int leg = 0; leg < 4; ++leg)
    qs_leg_accel(F, leg, rq + 3 * leg, ub, udot + 6 + 3 * leg);

  // Semi-implicit Euler: velocity first (clamped, NaN passes), then pose.
  float u_new[18], x_new[3], q_new[12], R_new[9], Rv[3], wh[3], Ex[9];
  for (int k = 0; k < 18; ++k)
    u_new[k] = qclamp(u[k] + h * udot[k], -200.0f, 200.0f);
  m3_mv(Rv, R, u_new + 3);
  for (int k = 0; k < 3; ++k) {
    x_new[k] = x[k] + h * Rv[k];
    wh[k] = u_new[k] * h;
  }
  so3_exp_f(wh, Ex);
  m3_mul(R_new, R, Ex);
  for (int k = 0; k < 12; ++k) q_new[k] = q[k] + h * u_new[6 + k];

  // Freeze-on-nonfinite: a NaN or Inf anywhere poisons the |.|-sum.
  float nf = 0.0f;
  for (int k = 0; k < 9; ++k) nf = nf + fabsf(R_new[k]);
  for (int k = 0; k < 3; ++k) nf = nf + fabsf(x_new[k]);
  for (int k = 0; k < 18; ++k) nf = nf + fabsf(u_new[k]);
  for (int k = 0; k < 12; ++k) nf = nf + fabsf(q_new[k]);
  for (int k = 0; k < 16; ++k) nf = nf + fabsf(anchor_new[k]);
  if (nf < 1e30f) {
    for (int k = 0; k < 9; ++k) R[k] = R_new[k];
    for (int k = 0; k < 3; ++k) x[k] = x_new[k];
    for (int k = 0; k < 18; ++k) u[k] = u_new[k];
    for (int k = 0; k < 12; ++k) q[k] = q_new[k];
    for (int k = 0; k < 16; ++k) anchor[k] = anchor_new[k];
  } else {
    for (int k = 0; k < 18; ++k) u[k] = 0.0f;  // frozen crash site
  }
}

QCT_DEV void substep_instance_serial(const QctSubIO& io, int B, int i,
                                     int n_substeps, float h,
                                     const QctSubParams& P) {
  float st[QS_N_STATE], tau[12];
  for (int k = 0; k < QS_N_STATE; ++k) st[k] = io.state[(size_t)k * B + i];
  float sn[12], cs[12];
  for (int k = 0; k < 12; ++k) {
    sn[k] = sinf(st[30 + k]);
    cs[k] = cosf(st[30 + k]);
  }

  // Torque-map prologue.
  if (P.torque_qp) {
    for (int leg = 0; leg < 4; ++leg) {
      float f_w[3], tsw[3];
      for (int k = 0; k < 3; ++k) {
        f_w[k] = io.a[(size_t)(3 * leg + k) * B + i];
        tsw[k] = io.tau_sw[(size_t)(3 * leg + k) * B + i];
      }
      qs_torque_leg(P, leg, st, sn, cs, f_w, tsw, io.st[(size_t)leg * B + i],
                    tau + 3 * leg);
    }
  } else {
    for (int k = 0; k < 12; ++k) tau[k] = io.a[(size_t)k * B + i];
  }

  // The tick's factor: built here from q, or streamed in.
  QctFactor F;
  if (P.prefactor_kernel) {
    qs_build_factor(P, sn, cs, F);
  } else {
    const float* f = io.factor + i;
    for (int k = 0; k < 36; ++k) F.Dinv[k] = f[(size_t)k * B];
    for (int k = 0; k < 72; ++k) F.Bl[k] = f[(size_t)(36 + k) * B];
    for (int k = 0; k < 72; ++k) F.BDinv[k] = f[(size_t)(108 + k) * B];
    for (int k = 0; k < 36; ++k) F.Sinv[k] = f[(size_t)(180 + k) * B];
  }

  for (int n = 0; n < n_substeps; ++n) qs_substep(P, F, tau, h, st);
  for (int k = 0; k < QS_N_STATE; ++k) io.out[(size_t)k * B + i] = st[k];
}

// ---------------------------------------------------------------------------
// The lane body: one robot on QS_G lanes, its state in shared memory.
// ---------------------------------------------------------------------------

// v[k] for a lane-dependent k < 3 of a register array (selects, so that the
// array stays in registers).
QCT_DEV float qs_pick3(const float* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// A thread's place in its group: its lane.
struct QSLane {
  int lane;
};

#ifdef __CUDACC__
#define QS_WARP_SYNC() __syncwarp()
#endif
#ifdef QS_WARP_SYNC
#define QS_PHASE(lane)                              \
  for (int lane = g.lane, qs_once_ = 1; qs_once_; \
       qs_once_ = 0, QS_WARP_SYNC(), QCT_CLOCK(__LINE__))
#else
#ifndef QS_HOST_LANES
#define QS_HOST_LANES(lane) for (int lane = 0; lane < QS_G; ++lane)
#endif
#define QS_PHASE(lane) QS_HOST_LANES(lane)
#endif

// Work items 0 .. n-1 of a section over the group's lanes: every lane runs
// ceil(n / QS_G) rounds of the body, on item k = (lane + round QS_G) mod n,
// and own is true where that item is the lane's (lane + round QS_G < n).
// The lanes past n run a copy of an item and store nothing (their stores are
// under own), so that the section is one stream of code for every lane:
// independent items of a section (a leg's RNEA sweep and a contact point)
// interleave in it, and no branch depends on the lane.
#define QS_ITEMS(k, own, lane, n)                                         \
  _Pragma("unroll") for (int k##_r_ = 0; k##_r_ < ((n) + QS_G - 1) / QS_G; \
                         ++k##_r_)                                        \
    for (int k##_i_ = (lane) + k##_r_ * QS_G, k = k##_i_ % (n),          \
             own = k##_i_ < (n), k##_once_ = 1;                           \
         k##_once_; k##_once_ = 0)

// Words of a robot's QSShared before the padding.
#define QS_WORDS 646
// One robot's state. The staged inputs (st | a | tau_sw | stance | F) lie
// in the order qs_stage_in reads them; nw holds the substep's new state in
// st's order (R 9, x 3, u 18, q 12, anchor 16), which is also the order of
// the guard's sum. The size is QS_G words mod 32, so that the QS_G-lane
// groups of a warp, each reading QS_G consecutive words of its own state,
// hit 32 different banks.
struct QSShared {
  float st[QS_N_STATE];  // the state, updated every substep
  float a[12];           // world GRFs (qp) or joint torques (tau)
  float tau_sw[12];      // qp only
  float stance[4];       // qp only
  QctFactor F;           // the tick's factor, built or streamed
  float tau[12];         // the tick's joint torques
  float sn[12], cs[12];  // of q at the substep's start
  float bias_q[12];      // RNEA joint bias torques
  float legf[24];        // [leg][6]: a leg's wrench on the base
  float ptf[48];         // [point][6]: pxf | f_b of a contact point
  float g_q[12];         // contact joint torques
  float nw[QS_N_STATE];  // the new state, anchors from the contact points
  float sn2[12], cs2[12];  // of the new q
  float rb[6];           // Schur solve: base right-hand side
  float tot[52];         // prologue: a leg's composite inertia at the base
  float S[36], Y[36];    // prologue: the Schur complement, L^-1
  float pad[(QS_G - QS_WORDS % 32 + 32) % 32];
};
static_assert(sizeof(QSShared) / sizeof(float) ==
                  QS_WORDS + (QS_G - QS_WORDS % 32 + 32) % 32,
              "QS_WORDS counts QSShared's words");
static_assert(sizeof(QSShared) / sizeof(float) % 32 == QS_G % 32,
              "a robot's state is QS_G words mod 32 (banks)");
static_assert(offsetof(QSShared, a) == 58 * sizeof(float) &&
                  offsetof(QSShared, tau_sw) == 70 * sizeof(float) &&
                  offsetof(QSShared, stance) == 82 * sizeof(float) &&
                  offsetof(QSShared, F) == 86 * sizeof(float),
              "staged inputs lie in launch order");

// What the launch geometry is made from (kernels.substep_launch_geometry):
// lanes per robot, threads a block at most, shared words per robot.
static inline void qs_layout(int* out) {
  out[0] = QS_G;
  out[1] = QS_MAX_THREADS;
  out[2] = (int)(sizeof(QSShared) / sizeof(float));
}

// Thread t of nt stages the inputs of nr robot slots from slot0 into W[0 ..
// nr) (a slot past B takes robot B - 1; nt a multiple of nr): the state, a,
// then tau_sw and stance (qp) and the streamed factor. Threads t and t + 1
// read row k of neighbouring robots, so a load of the block's nr robots
// reads nr consecutive words of the (k, B) layout.
QCT_DEV void qs_stage_in(const QctSubIO& io, const QctSubParams& P, int B,
                         int slot0, int nr, QSShared* W, int t, int nt) {
  const int q = t % nr, dk = nt / nr;
  const int i = slot0 + q < B ? slot0 + q : B - 1;
  const int n_qp = P.torque_qp ? 16 : 0;
  const int n_in = 70 + n_qp + (P.prefactor_kernel ? 0 : QS_N_FACTOR);
  float* w = reinterpret_cast<float*>(W + q);
  for (int k = t / nr; k < n_in; k += dk) {
    const float* src;
    int row = k, off = k;
    if (k < 58) {
      src = io.state;
    } else if (k < 70) {
      src = io.a;
      row = k - 58;
    } else if (k < 70 + n_qp) {
      src = k < 82 ? io.tau_sw : io.st;
      row = k < 82 ? k - 70 : k - 82;
    } else {
      src = io.factor;
      row = k - 70 - n_qp;
      off = 86 + row;
    }
    w[off] = src[(size_t)row * B + i];
  }
}

// Thread t of nt writes the new states of the slots below B.
QCT_DEV void qs_stage_out(const QctSubIO& io, int B, int slot0, int nr,
                          const QSShared* W, int t, int nt) {
  const int q = t % nr, dk = nt / nr, i = slot0 + q;
  if (i >= B) return;
  for (int k = t / nr; k < QS_N_STATE; k += dk)
    io.out[(size_t)k * B + i] = W[q].st[k];
}

// The kernel's body on one robot's staged state S (a, tau_sw, stance and,
// when streamed, F staged too): the torque map and the factor, then
// n_substeps substeps; the new state in S.st on return.
QCT_DEV void substep_lanes(QSShared& S, const QctSubParams& P,
                           int n_substeps, float h, const QSLane& g) {
  QCT_CLOCK(0);
  // Prologue. The sines / cosines of q (the first substep's too).
  QS_PHASE(lane) {
    QS_ITEMS(k, own, lane, 12) {
      const float sk = sinf(S.st[30 + k]), ck = cosf(S.st[30 + k]);
      if (own) {
        S.sn[k] = sk;
        S.cs[k] = ck;
      }
    }
  }
  // A leg's torque map and composite-rigid-body block (lanes 0-3; the two
  // pieces write their blocks straight into shared memory, so the other
  // lanes wait rather than run copies).
  QS_PHASE(lane) {
    for (int leg = lane; leg < 4; leg += QS_G) {
      if (P.torque_qp)
        qs_torque_leg(P, leg, S.st, S.sn, S.cs, S.a + 3 * leg,
                      S.tau_sw + 3 * leg, S.stance[leg], S.tau + 3 * leg);
      else
        for (int j = 0; j < 3; ++j) S.tau[3 * leg + j] = S.a[3 * leg + j];
      if (P.prefactor_kernel)
        qs_factor_leg(P, leg, S.sn, S.cs, S.F, S.tot + 13 * leg);
    }
  }
  if (P.prefactor_kernel) {
    // S by entries (each lane adds up the tree's totals itself), then L^-1
    // in lane 0, then Sinv by entries.
    QS_PHASE(lane) {
      float m_tot, h_tot[3], J_tot[9];
      qs_tree_totals(P, S.tot, m_tot, h_tot, J_tot);
      QS_ITEMS(e, own, lane, 36) {
        const float v = qs_schur_entry(S.F, e / 6, e % 6, m_tot, h_tot, J_tot);
        if (own) S.S[e] = v;
      }
    }
    QS_PHASE(lane) {
      if (lane == 0) qs_chol_inv(S.S, S.Y);
    }
    QS_PHASE(lane) {
      QS_ITEMS(e, own, lane, 36) {
        const float v = qs_sinv_entry(S.Y, e / 6, e % 6);
        if (own) S.F.Sinv[e] = v;
      }
    }
  }

  const float* st = S.st;
  const float* qd = S.st + 18;
  for (int n = 0; n < n_substeps; ++n) {
    const bool more = n + 1 < n_substeps;
    // The legs' RNEA sweeps and the contact points.
    QS_PHASE(lane) {
      QS_ITEMS(leg, own, lane, 4) {
        float g_base[3], bias[3], wrench[6];
        qs_gravity_base(P, st, g_base);
        qs_rnea_leg(P, leg, S.sn + 3 * leg, S.cs + 3 * leg, st + 12, st + 15,
                    qd + 3 * leg, g_base, bias, wrench);
        if (own) {
          for (int j = 0; j < 3; ++j) S.bias_q[3 * leg + j] = bias[j];
          for (int j = 0; j < 6; ++j) S.legf[6 * leg + j] = wrench[j];
        }
      }
      QS_ITEMS(p, own, lane, 8) {
        float anchor2[2], pf[6], gq[3];
        qs_contact(P, p, S.sn, S.cs, st, anchor2, pf, pf + 3, gq);
        if (own) {
          S.nw[42 + 2 * p] = anchor2[0];
          S.nw[43 + 2 * p] = anchor2[1];
          for (int j = 0; j < 6; ++j) S.ptf[6 * p + j] = pf[j];
          if (p < 4)
            for (int j = 0; j < 3; ++j) S.g_q[3 * p + j] = gq[j];
        }
      }
    }
    // Base rows of the right-hand side: the trunk's bias plus the legs',
    // the contact points' sum, less BDinv rq.
    QS_PHASE(lane) {
      QS_ITEMS(r, own, lane, 6) {
        float f0w[3], f0v[3], rq[12];
        qs_trunk_bias(P, st, f0w, f0v);
        float f0 = r < 3 ? qs_pick3(f0w, r) : qs_pick3(f0v, r - 3);
        for (int leg = 0; leg < 4; ++leg) f0 = f0 + S.legf[6 * leg + r];
        float gr = 0.0f;
        for (int p = 0; p < 8; ++p) gr = gr + S.ptf[6 * p + r];
        for (int k = 0; k < 12; ++k)
          rq[k] = qs_rq(P, S.tau, qd, S.g_q, S.bias_q, k);
        const float rb = qs_rb_row(S.F, r, gr - f0, rq);
        if (own) S.rb[r] = rb;
      }
    }
    // The new velocities (semi-implicit Euler, clamped, NaN passes): the
    // base's from Sinv rb (every lane forms all six base accelerations), a
    // leg's from its joint accelerations.
    QS_PHASE(lane) {
      const float* u = st + 12;
      float ub[6];
      for (int r = 0; r < 6; ++r) ub[r] = qs_ub_row(S.F, r, S.rb);
      QS_ITEMS(r, own, lane, 6) {
        const float a = r < 3 ? qs_pick3(ub, r) : qs_pick3(ub + 3, r - 3);
        const float v = qclamp(u[r] + h * a, -200.0f, 200.0f);
        if (own) S.nw[12 + r] = v;
      }
      QS_ITEMS(leg, own, lane, 4) {
        float rq3[3], qdd[3];
        for (int j = 0; j < 3; ++j)
          rq3[j] = qs_rq(P, S.tau, qd, S.g_q, S.bias_q, 3 * leg + j);
        qs_leg_accel(S.F, leg, rq3, ub, qdd);
        if (own)
          for (int j = 0; j < 3; ++j)
            S.nw[18 + 3 * leg + j] =
                qclamp(u[6 + 3 * leg + j] + h * qdd[j], -200.0f, 200.0f);
      }
    }
    // The new pose from the new velocities, and the sines / cosines of the
    // new q for the next substep.
    QS_PHASE(lane) {
      const float* un = S.nw + 12;
      float wh[3], Ex[9];
      for (int k = 0; k < 3; ++k) wh[k] = un[k] * h;
      so3_exp_f(wh, Ex);
      QS_ITEMS(e, own, lane, 9) {
        const int i = e / 3, j = e % 3;
        const float v = st[3 * i] * qs_pick3(Ex, j) +
                        st[3 * i + 1] * qs_pick3(Ex + 3, j) +
                        st[3 * i + 2] * qs_pick3(Ex + 6, j);
        if (own) S.nw[e] = v;
      }
      QS_ITEMS(k, own, lane, 3) {
        const float v = st[9 + k] + h * (st[3 * k] * un[3] +
                                         st[3 * k + 1] * un[4] +
                                         st[3 * k + 2] * un[5]);
        if (own) S.nw[9 + k] = v;
      }
      QS_ITEMS(k, own, lane, 12) {
        const float v = st[30 + k] + h * un[6 + k];
        if (own) S.nw[30 + k] = v;
        if (own && more) {
          S.sn2[k] = sinf(v);
          S.cs2[k] = cosf(v);
        }
      }
    }
    // The guard (every lane sums the 58 words in order) and the write-back.
    QS_PHASE(lane) {
      float nf = 0.0f;
      for (int k = 0; k < QS_N_STATE; ++k) nf = nf + fabsf(S.nw[k]);
      const bool ok = nf < 1e30f;
      QS_ITEMS(k, own, lane, 30) {
        if (own && (ok || k >= 12)) S.st[k] = ok ? S.nw[k] : 0.0f;
      }
      QS_ITEMS(k, own, lane, 28) {
        if (own && ok) {
          S.st[30 + k] = S.nw[30 + k];
          if (k < 12 && more) {
            S.sn[k] = S.sn2[k];
            S.cs[k] = S.cs2[k];
          }
        }
      }
    }
  }
}
