// K5: N physics substeps of the whole-body plant, one robot per thread.
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
// NaN handling decides the guard: the velocity clamp must pass a NaN through
// (qclamp, like torch.clamp) so that the |.|-sum of the new state is NaN,
// "sum < 1e30" is false and the lane freezes. fminf/fmaxf would turn the
// NaN into +-200 and let a poisoned lane run on.
#pragma once

#include "qct_vec.cuh"

#define QS_N_STATE 58
#define QS_N_FACTOR 216

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

// RNEA sweep of one leg at zero joint acceleration and base acceleration
// g_base (the gravity trick). Writes the three joint bias torques and ADDS
// the leg's wrench on the base to (f0w, f0v).
QCT_DEV void qs_rnea_leg(const QctSubParams& P, int leg, const float* s,
                         const float* c, const float* w_b, const float* v_b,
                         const float* qd, const float* g_base, float* bias_q,
                         float* f0w, float* f0v) {
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
  v3_add(f0w, f0w, fw_c);
  v3_add(f0v, f0v, fv_c);
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

// Composite-rigid-body assembly of the tree-sparse blocks + Schur prefactor
// + Cholesky 6x6 inverse, from the tick-start sines/cosines of q
// (sim/fused_substep.py::build_factor_plain).
QCT_DEV_NOINLINE void qs_build_factor(const QctSubParams& P, const float* sn,
                                      const float* cs, QctFactor& F) {
  float m_tot = P.trunk_m;
  float h_tot[3] = {0.0f, 0.0f, 0.0f};
  float J_tot[9];
  for (int k = 0; k < 9; ++k) J_tot[k] = 0.0f;
  for (int k = 0; k < 3; ++k) J_tot[4 * k] = P.trunk_I[k];
  for (int leg = 0; leg < 4; ++leg) {
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
    {
      float h_b[3], J_b[9];
      qs_xform_inertia(E, P.joint_r + 9 * leg, mc[0], hc, Jc, h_b, J_b);
      m_tot = m_tot + mc[0];
      v3_add(h_tot, h_tot, h_b);
      for (int k = 0; k < 9; ++k) J_tot[k] = J_tot[k] + J_b[k];
    }
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
        qs_force_up(E + 9 * (i + 1), P.joint_r + 3 * (3 * leg + i + 1), fw,
                    fv);
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
  // S = A - sum_leg BDinv_leg Bl_leg^T with A = [[J, h^], [h^T, m I]].
  float S[36];
  {
    float hhat[9];
    m3_skew(hhat, h_tot);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        S[6 * i + j] = J_tot[3 * i + j];
        S[6 * i + 3 + j] = hhat[3 * i + j];
        S[6 * (3 + i) + j] = hhat[3 * j + i];
        S[6 * (3 + i) + 3 + j] = (i == j) ? m_tot : 0.0f;
      }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float acc = 0.0f;
      for (int leg = 0; leg < 4; ++leg)
        for (int t = 0; t < 3; ++t)
          acc = acc + F.BDinv[18 * leg + 3 * i + t] * F.Bl[18 * leg + 3 * j + t];
      S[6 * i + j] = S[6 * i + j] - acc;
    }
  // Cholesky S = L L^T, Y = L^-1, Sinv = Y^T Y. A non-positive pivot gives
  // NaNs (sqrtf of a negative), never a trap.
  float L[36], Y[36];
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
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      float acc = Y[6 * hi + lo] * Y[7 * hi];
      for (int k = hi + 1; k < 6; ++k)
        acc = acc + Y[6 * k + lo] * Y[6 * k + hi];
      F.Sinv[6 * i + j] = acc;
    }
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
  float g_base[3], f0w[3], f0v[3], bias_q[12], t1[3], t2[3];
  for (int k = 0; k < 3; ++k) g_base[k] = P.gravity * R[6 + k];
  for (int k = 0; k < 3; ++k) t1[k] = P.trunk_I[k] * w_b[k];
  v3_cross(f0w, w_b, t1);
  v3_scale(t1, P.trunk_m, v_b);
  v3_cross(t2, w_b, t1);
  for (int k = 0; k < 3; ++k) f0v[k] = P.trunk_m * g_base[k] + t2[k];
  for (int leg = 0; leg < 4; ++leg)
    qs_rnea_leg(P, leg, sn + 3 * leg, cs + 3 * leg, w_b, v_b, qd + 3 * leg,
                g_base, bias_q + 3 * leg, f0w, f0v);

  // Contact: 4 feet, then 4 trunk corners.
  float g_w[3] = {0.0f, 0.0f, 0.0f}, g_v[3] = {0.0f, 0.0f, 0.0f};
  float g_q[12], anchor_new[16];
  for (int k = 0; k < 12; ++k) g_q[k] = 0.0f;
  for (int p = 0; p < 8; ++p) {
    const int leg = p & 3;
    float pt_b[3], Jl[9], v_pt[3];
    if (p < 4) {
      const float s2 = sn[3 * leg + 1], c2 = cs[3 * leg + 1];
      const float s3 = sn[3 * leg + 2], c3 = cs[3 * leg + 2];
      leg_fk_jac(sn[3 * leg], cs[3 * leg], s2, c2, s2 * c3 + c2 * s3,
                 c2 * c3 - s2 * s3, P.l1s[leg], P.sl2, P.sl3,
                 P.hips + 3 * leg, pt_b, Jl);
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
      anchor_new[2 * p] =
          in_contact ? p_w[0] + (ftx + P.ct * v_w[0]) / P.kt : p_w[0];
      anchor_new[2 * p + 1] =
          in_contact ? p_w[1] + (fty + P.ct * v_w[1]) / P.kt : p_w[1];
    } else {
      const float speed = sqrtf(v_w[0] * v_w[0] + v_w[1] * v_w[1] + 1e-16f);
      const float scale = P.mu * fn / qmax(speed, P.v_s);
      ftx = -scale * v_w[0];
      fty = -scale * v_w[1];
      anchor_new[2 * p] = p_w[0];
      anchor_new[2 * p + 1] = p_w[1];
    }
    const float f_w[3] = {ftx, fty, fn};
    float f_b[3], pxf[3];
    m3_mtv(f_b, R, f_w);
    v3_cross(pxf, pt_b, f_b);
    v3_add(g_w, g_w, pxf);
    v3_add(g_v, g_v, f_b);
    if (p < 4) m3_mtv(g_q + 3 * leg, Jl, f_b);
  }

  // Solve M udot = rhs with the prefactored Schur form.
  float rb[6], rq[12], ub[6], udot[18];
  for (int k = 0; k < 3; ++k) {
    rb[k] = g_w[k] - f0w[k];
    rb[3 + k] = g_v[k] - f0v[k];
  }
  for (int k = 0; k < 12; ++k)
    rq[k] = tau[k] - P.damp[k] * qd[k] + g_q[k] - bias_q[k];
  for (int leg = 0; leg < 4; ++leg)
    for (int r = 0; r < 6; ++r) {
      float acc = 0.0f;
      for (int cc = 0; cc < 3; ++cc)
        acc = acc + F.BDinv[18 * leg + 3 * r + cc] * rq[3 * leg + cc];
      rb[r] = rb[r] - acc;
    }
  for (int r = 0; r < 6; ++r) {
    float acc = 0.0f;
    for (int cc = 0; cc < 6; ++cc) acc = acc + F.Sinv[6 * r + cc] * rb[cc];
    ub[r] = acc;
    udot[r] = acc;
  }
  for (int leg = 0; leg < 4; ++leg) {
    float t[3];
    for (int cc = 0; cc < 3; ++cc) {
      float acc = 0.0f;
      for (int r = 0; r < 6; ++r)
        acc = acc + F.Bl[18 * leg + 3 * r + cc] * ub[r];
      t[cc] = rq[3 * leg + cc] - acc;
    }
    for (int r = 0; r < 3; ++r)
      udot[6 + 3 * leg + r] = F.Dinv[9 * leg + 3 * r] * t[0] +
                              F.Dinv[9 * leg + 3 * r + 1] * t[1] +
                              F.Dinv[9 * leg + 3 * r + 2] * t[2];
  }

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

QCT_DEV void substep_instance(const QctSubIO& io, int B, int i,
                              int n_substeps, float h,
                              const QctSubParams& P) {
  float st[QS_N_STATE], tau[12];
  for (int k = 0; k < QS_N_STATE; ++k) st[k] = io.state[(size_t)k * B + i];
  float sn[12], cs[12];
  for (int k = 0; k < 12; ++k) {
    sn[k] = sinf(st[30 + k]);
    cs[k] = cosf(st[30 + k]);
  }

  // Torque-map prologue: f_b = -R^T f_w, tau = J^T f_b on stance legs,
  // swing PD torques elsewhere, + leg gravity torques, clamped.
  if (P.torque_qp) {
    const float* R = st;
    float tau_g[12];
    for (int k = 0; k < 12; ++k) tau_g[k] = 0.0f;
    if (P.gravity_comp) {
      const float zero3[3] = {0.0f, 0.0f, 0.0f};
      float g_base[3], sink_w[3] = {0.0f, 0.0f, 0.0f},
                       sink_v[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < 3; ++k) g_base[k] = P.gravity * R[6 + k];
      for (int leg = 0; leg < 4; ++leg)
        qs_rnea_leg(P, leg, sn + 3 * leg, cs + 3 * leg, zero3, zero3, zero3,
                    g_base, tau_g + 3 * leg, sink_w, sink_v);
    }
    for (int leg = 0; leg < 4; ++leg) {
      const bool stance = io.st[(size_t)leg * B + i] > 0.5f;
      float f_w[3], rtf[3], f_b[3], Jl[9], tau_st[3];
      for (int k = 0; k < 3; ++k)
        f_w[k] = io.a[(size_t)(3 * leg + k) * B + i];
      m3_mtv(rtf, R, f_w);
      v3_scale(f_b, -1.0f, rtf);
      const float s2 = sn[3 * leg + 1], c2 = cs[3 * leg + 1];
      const float s3 = sn[3 * leg + 2], c3 = cs[3 * leg + 2];
      leg_fk_jac(sn[3 * leg], cs[3 * leg], s2, c2, s2 * c3 + c2 * s3,
                 c2 * c3 - s2 * s3, P.l1s[leg], P.sl2, P.sl3,
                 P.hips + 3 * leg, nullptr, Jl);
      m3_mtv(tau_st, Jl, f_b);
      for (int j = 0; j < 3; ++j) {
        const int idx = 3 * leg + j;
        float v = stance ? tau_st[j] : io.tau_sw[(size_t)idx * B + i];
        if (P.gravity_comp) v = v + tau_g[idx];
        tau[idx] = qclamp(v, P.tau_min, P.tau_max);
      }
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
