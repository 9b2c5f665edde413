// K4: the commander tick's pre-QP stage.
//
// Replaces the TPU kernel body
// quadruped_control_tpu/control/pallas_commander.py::commander_pre_sym
// (launched there by _pre_kernel). The statements follow the plain PyTorch
// version, control/fused_commander.py::commander_pre_plain, one for one
// (same operation order; the library is compiled with -fmad=false), so the
// two differ only where sinf/cosf/atan2f differ from PyTorch's.
//
// Two bodies. commander_instance_serial runs one control instance in one
// thread (the kernel's first form, kept as the reference: the host shim's
// host_commander_pre and the card's qct_commander_serial, which only
// chip_smoke.py's hold launches). commander_lanes is the kernel's: a group
// of QC_G lanes per instance, one leg a lane (QC_G = 4) or two (QC_G = 2).
// Every lane computes the leg-independent prefix (measurement, standing
// latch, gait clock, desired pose, the foothold's velocity terms) by the
// same statements on the same inputs, so every lane holds the same bits
// without an exchange; then the steps of its own legs (FK, gait phase,
// foothold, the sextic replan and its carry rows, the swing reference, IK,
// the contact-gated end-of-swing IK, the adjugate and damped inverse, swing
// PD) in the serial order; then its share of the leg-independent suffix
// (lane 0 the right-hand side b, the levers' constants and the scalar carry
// rows; lane 1 % QC_G the MPC block's xi0; lane t % QC_G the reference's
// step t). Each output word is written by exactly one lane. No shared
// memory, no shuffle, no sync: a lane reads only the kernel's inputs. So
// the two bodies are bitwise equal (tests/test_torch_commander_lanes.py on
// the host, chip_smoke.py on the card).
//
// Every max/min/clamp goes through the NaN-propagating qmax/qmin
// (qct_common.cuh), as torch.maximum / torch.clamp do; comparisons with a
// NaN are false on both sides.
#pragma once

#include "qct_vec.cuh"

// Lanes per instance (4: one leg a lane; 2: two legs a lane) and K4's block
// size; an instance's lanes are neighbouring threads. Other choices build
// with -DQC_G, -DQC_THREADS (scripts/torch_commander_widths.py times them).
#ifndef QC_G
#define QC_G 4
#endif
#ifndef QC_THREADS
#define QC_THREADS 64
#endif
static_assert(QC_G == 2 || QC_G == 4, "an instance runs on 2 or 4 lanes");
static_assert(QC_THREADS % 32 == 0 && QC_THREADS <= 1024,
              "a block is whole warps");

// A store of the lane body (the host shim counts them: one writer a word).
#ifndef QC_STORE
#define QC_STORE(p, v) (*(p) = (v))
#endif

#define QC_N_CARRY 95
#define QC_STANDING 0
#define QC_GAIT_TIME 1
#define QC_PREV 2
#define QC_INIT 6
#define QC_COEF 7
#define QC_VALID 91

// Runtime constants (mirrored by kernels.CommanderParams, same order).
struct QctCmdParams {
  float hips[12];  // [leg][xyz] base->hip
  float l1s[4];    // signed l1 per leg
  float l1, l2, l3, sl2, sl3;
  float l1_sq, ik_sum, inv_ik_den;
  float dt, dt_cmd, stand_h, stand_tol;
  float inv_period, stance_thresh, half_t_stance, swing_height;
  float offsets[4];
  float slope, intercept;
  float fp_hips[12];  // foot planner's hip offsets
  float fp_k, inv_fp_g;
  float kp_j[3], kd_j[3], kff_j[3];
  float mass;
  float inertia[3];
  float kp_p[3], kd_p[3], kp_w[3], kd_w[3];
  float kff[6];
  float kff_mg, gravity_z, mu, fz_min, fz_max;
  float a_inv[21];  // [k][0:3] of the sextic's inverse constraint matrix
  float contact_gate;
  int raibert_cmd_symmetric;
  int mpc_horizon;  // 0: no MPC precursor block
  double mpc_dt;    // products mpc_dt * k are rounded once, as on the host
};

// Inputs state (>= 42, B), carry (95, B), cmd (6, B); outputs as named.
struct QctCmdIO {
  const float* state;
  const float* carry;
  const float* cmd;
  float* r;          // (12, B)
  float* b;          // (6, B)
  float* st;         // (4, B)
  float* mu;         // (1, B)
  float* fzmin;      // (1, B)
  float* fzmax;      // (1, B)
  float* tau_swing;  // (12, B)
  float* carry_out;  // (95, B)
  float* q_ref;      // (12, B)
  float* mpc;        // (25 + 17 N, B) when mpc_horizon = N > 0, else unused
};

#define QC_TWO_PI 6.283185307179586f
#define QC_PI 3.141592653589793f

QCT_DEV float qc_wrap_2pi(float a) {
  const float w = a - floorf(a / QC_TWO_PI) * QC_TWO_PI;
  return w < 0.0f ? w + QC_TWO_PI : w;
}

QCT_DEV float qc_wrap_pi(float a) {
  const float shifted = a + QC_PI;
  float w = shifted - floorf(shifted / QC_TWO_PI) * QC_TWO_PI;
  w = w < 0.0f ? w + QC_TWO_PI : w;
  return w - QC_PI;
}

// math/rotations.so3_log: small / generic / near-pi regimes as dataflow,
// first-max tie-breaking for the dominant column.
QCT_DEV void qc_so3_log(const float* E, float* w) {
  const float tr = E[0] + E[4] + E[8];
  const float cos_t = qclamp(0.5f * (tr - 1.0f), -1.0f, 1.0f);
  const float ws[3] = {E[7] - E[5], E[2] - E[6], E[3] - E[1]};
  const float sin_t =
      0.5f * sqrtf(ws[0] * ws[0] + ws[1] * ws[1] + ws[2] * ws[2]);
  const float theta = atan2f(sin_t, cos_t);

  const bool small = theta < 1e-7f;
  const bool near_pi = theta > (float)(3.141592653589793 - 1e-2);
  const float gen_scale =
      small ? 0.5f * (1.0f + theta * theta / 6.0f)
            : 0.5f * theta / ((small || near_pi) ? 1.0f : sin_t);

  float Bm[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Bm[3 * i + j] = 0.5f * (E[3 * i + j] + E[3 * j + i]);
  const float add = 0.5f * (1.0f - tr);
  for (int i = 0; i < 3; ++i) Bm[4 * i] = Bm[4 * i] + add;
  const float d0 = Bm[0], d1 = Bm[4], d2 = Bm[8];
  const bool pick0 = (d0 >= d1) && (d0 >= d2);
  const bool pick1 = (!pick0) && (d1 >= d2);
  const int col = pick0 ? 0 : (pick1 ? 1 : 2);
  float axis[3] = {Bm[col], Bm[3 + col], Bm[6 + col]};
  const float norm = qmax(
      sqrtf(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]),
      1e-12f);
  for (int i = 0; i < 3; ++i) axis[i] = axis[i] / norm;
  const float dot_ws = axis[0] * ws[0] + axis[1] * ws[1] + axis[2] * ws[2];
  const float sgn_theta = dot_ws < 0.0f ? -theta : theta;
  for (int i = 0; i < 3; ++i)
    w[i] = near_pi ? axis[i] * sgn_theta : ws[i] * gen_scale;
}

// Analytic leg IK (ops/kinematics.inverse_kinematics); p hip-relative.
QCT_DEV void qc_ik(const QctCmdParams& c, int leg, const float* p,
                   float* qout) {
  const float x = p[0], y = p[1], z = p[2];
  float d = (x * x + y * y + z * z - c.ik_sum) * c.inv_ik_den;
  d = qclamp(d, -1.0f, 1.0f);
  const float root = sqrtf(qmax(y * y + z * z - c.l1_sq, 0.0f));
  const float neg_l1 = 0.0f - c.l1;
  if (leg < 2)
    qout[0] = -(atan2f(z, -y) + atan2f(root, neg_l1));
  else
    qout[0] = atan2f(z, y) + atan2f(root, neg_l1);
  const float s2v = -sqrtf(qmax(1.0f - d * d, 0.0f));
  qout[2] = atan2f(s2v, d);
  qout[1] = -atan2f(x, root) - atan2f(c.l3 * s2v, c.l2 + c.l3 * d);
}

QCT_DEV void commander_instance_serial(const QctCmdIO& io, int B, int i,
                                       const QctCmdParams& c) {
  const float* S = io.state + i;
  const float* C = io.carry + i;
  float R[9], x[3], w_b[3], v_b[3], qd[12], q[12], cmd[6];
  for (int k = 0; k < 9; ++k) R[k] = S[(size_t)k * B];
  for (int k = 0; k < 3; ++k) {
    x[k] = S[(size_t)(9 + k) * B];
    w_b[k] = S[(size_t)(12 + k) * B];
    v_b[k] = S[(size_t)(15 + k) * B];
  }
  for (int k = 0; k < 12; ++k) {
    qd[k] = S[(size_t)(18 + k) * B];
    q[k] = S[(size_t)(30 + k) * B];
  }
  for (int k = 0; k < 6; ++k) cmd[k] = io.cmd[(size_t)k * B + i];

  const float standing0 = C[(size_t)QC_STANDING * B];
  const float gait_time0 = C[(size_t)QC_GAIT_TIME * B];
  const float initialized = C[(size_t)QC_INIT * B];

  // Measurement: world twist.
  float w_w[3], xdot_w[3];
  m3_mv(w_w, R, w_b);
  m3_mv(xdot_w, R, v_b);

  // 1. FK.
  float feet_body[12];
  for (int leg = 0; leg < 4; ++leg) {
    const float s1 = sinf(q[3 * leg]), c1 = cosf(q[3 * leg]);
    const float s2 = sinf(q[3 * leg + 1]), c2 = cosf(q[3 * leg + 1]);
    const float s3 = sinf(q[3 * leg + 2]), c3 = cosf(q[3 * leg + 2]);
    const float s23 = s2 * c3 + c2 * s3;
    const float c23 = c2 * c3 - s2 * s3;
    leg_fk_jac(s1, c1, s2, c2, s23, c23, c.l1s[leg], c.sl2, c.sl3,
               c.hips + 3 * leg, feet_body + 3 * leg, nullptr);
  }

  // 2. Standing latch + gait clock.
  const bool near = fabsf(x[2] - c.stand_h) < c.stand_tol;
  const float standing = qmax(standing0, near ? 1.0f : 0.0f);
  const bool running = gait_time0 >= 0.0f;
  const float gait_time =
      running ? gait_time0 + c.dt : (standing > 0.5f ? 0.0f : gait_time0);
  const bool walking = gait_time >= 0.0f;

  // 3. Desired pose (integrate_twist_yaw under the walking mask).
  float aa[3], v_dt[3], Rbbp[9], tbbp[3];
  for (int k = 0; k < 3; ++k) {
    aa[k] = cmd[3 + k] * c.dt_cmd;
    v_dt[k] = cmd[k] * c.dt_cmd;
  }
  so3_exp_f(aa, Rbbp);
  m3_mv(tbbp, Rbbp, v_dt);
  const float yaw = atan2f(R[3], R[0]);
  const float cy = cosf(yaw), sy = sinf(yaw);
  float R_d[9], x_d[3], xdot_d[3], w_d[3];
  for (int j = 0; j < 3; ++j) {
    const float e0 = (j == 0) ? 1.0f : 0.0f;
    const float e1 = (j == 1) ? 1.0f : 0.0f;
    const float e2 = (j == 2) ? 1.0f : 0.0f;
    R_d[j] = walking ? cy * Rbbp[j] - sy * Rbbp[3 + j] : e0;
    R_d[3 + j] = walking ? sy * Rbbp[j] + cy * Rbbp[3 + j] : e1;
    R_d[6 + j] = walking ? Rbbp[6 + j] : e2;
  }
  x_d[0] = walking ? cy * tbbp[0] - sy * tbbp[1] + x[0] : 0.0f;
  x_d[1] = walking ? sy * tbbp[0] + cy * tbbp[1] + x[1] : 0.0f;
  x_d[2] = c.stand_h;  // height pinned in both branches
  {
    // Vw = Ad(Twb) cmd with the reference's inverse-adjoint quirk:
    // lin = R^T (v - x x w), ang = R^T w.
    float xw[3], delta[3], lin[3], ang[3];
    v3_cross(xw, x, cmd + 3);
    for (int k = 0; k < 3; ++k) delta[k] = cmd[k] - xw[k];
    m3_mtv(lin, R, delta);
    m3_mtv(ang, R, cmd + 3);
    for (int k = 0; k < 3; ++k) {
      xdot_d[k] = walking ? lin[k] : 0.0f;
      w_d[k] = walking ? ang[k] : 0.0f;
    }
  }

  // 4. Gait schedule.
  const float t_gait = qmax(gait_time, 0.0f);
  bool in_stance[4];
  float phase[4];
  for (int leg = 0; leg < 4; ++leg) {
    float ph = c.offsets[leg] + t_gait * c.inv_period;
    ph = ph - floorf(ph);
    in_stance[leg] = (ph <= c.stance_thresh) || !walking;
    phase[leg] = walking ? ph : 0.0f;
  }

  // 5. Foothold planning.
  const bool init_m = initialized > 0.5f;
  float pcom_foot[12], p_start[12], foothold[8];
  bool replan[4];
  const float* v_sym = c.raibert_cmd_symmetric ? xdot_d : xdot_w;
  float p_lin[2], p_lip[2];
  const float lip = 0.5f * sqrtf(qmax(x[2], 0.0f) * c.inv_fp_g);
  for (int k = 0; k < 2; ++k) {
    p_lin[k] = c.half_t_stance * v_sym[k] + c.fp_k * (xdot_w[k] - xdot_d[k]);
    p_lip[k] = lip * xdot_w[k];
  }
  for (int leg = 0; leg < 4; ++leg) {
    const float prev = C[(size_t)(QC_PREV + leg) * B];
    replan[leg] = !in_stance[leg] && ((prev > 0.5f) || !init_m);
    m3_mv(pcom_foot + 3 * leg, R, feet_body + 3 * leg);
    const float* hip = c.fp_hips + 3 * leg;
    float tang[3];
    v3_cross(tang, w_w, pcom_foot + 3 * leg);
    for (int k = 0; k < 2; ++k) {
      const float hip_w = R[3 * k] * hip[0] + R[3 * k + 1] * hip[1] +
                          R[3 * k + 2] * hip[2] + x[k];
      const float fh =
          hip_w + (p_lin[k] + p_lip[k]) + c.half_t_stance * tang[k];
      foothold[2 * leg + k] = replan[leg] ? fh : 0.0f;  // z is 0
    }
    for (int k = 0; k < 3; ++k)
      p_start[3 * leg + k] = pcom_foot[3 * leg + k] + x[k];
  }

  // 6-8 per leg: swing-trajectory replan, references, IK, J^-1, swing PD.
  float* CO = io.carry_out + i;
  bool eff_stance[4];
  for (int leg = 0; leg < 4; ++leg) {
    float coef[21];  // [k][axis]
    const float pc[3] = {
        0.5f * (p_start[3 * leg] + foothold[2 * leg]),
        0.5f * (p_start[3 * leg + 1] + foothold[2 * leg + 1]),
        c.swing_height};
    for (int ax = 0; ax < 3; ++ax) {
      const float p0 = p_start[3 * leg + ax];
      const float pf = ax < 2 ? foothold[2 * leg + ax] : 0.0f;
      for (int k = 0; k < 7; ++k) {
        const float nw = c.a_inv[3 * k] * p0 + c.a_inv[3 * k + 1] * pf +
                         c.a_inv[3 * k + 2] * pc[ax];
        const float old = C[(size_t)(QC_COEF + leg * 21 + k * 3 + ax) * B];
        const float v = replan[leg] ? nw : old;
        coef[3 * k + ax] = v;
        CO[(size_t)(QC_COEF + leg * 21 + k * 3 + ax) * B] = v;
      }
    }
    const float valid0 = C[(size_t)(QC_VALID + leg) * B];
    const float valid =
        replan[leg] ? 1.0f : (valid0 > 0.5f ? 1.0f : 0.0f);
    CO[(size_t)(QC_VALID + leg) * B] = valid;
    CO[(size_t)(QC_PREV + leg) * B] = in_stance[leg] ? 1.0f : 0.0f;

    // Swing reference on the sextic at the phase's trajectory time.
    const float t = qclamp(c.slope * phase[leg] + c.intercept, 0.0f, 1.0f);
    float pw[3] = {0.0f, 0.0f, 0.0f}, vw[3] = {0.0f, 0.0f, 0.0f};
    float tp = 1.0f;
    for (int k = 0; k < 7; ++k) {
      for (int ax = 0; ax < 3; ++ax) pw[ax] = pw[ax] + coef[3 * k + ax] * tp;
      tp = tp * t;
    }
    tp = 1.0f;
    for (int k = 1; k < 7; ++k) {
      for (int ax = 0; ax < 3; ++ax)
        vw[ax] = vw[ax] + (float)k * coef[3 * k + ax] * tp;
      tp = tp * t;
    }
    const bool vmask = valid > 0.5f;
    for (int ax = 0; ax < 3; ++ax) {
      pw[ax] = vmask ? pw[ax] : 0.0f;
      vw[ax] = vmask ? vw[ax] : 0.0f;
    }

    // p_b = R^T p_w - x (the reference's quirk), then hip-relative.
    const float* hip = c.hips + 3 * leg;
    float rtp[3], p_rel[3], v_b_ref[3], qr[3];
    m3_mtv(rtp, R, pw);
    for (int k = 0; k < 3; ++k) p_rel[k] = rtp[k] - x[k] - hip[k];
    m3_mtv(v_b_ref, R, vw);
    qc_ik(c, leg, p_rel, qr);

    bool gated = false;
    bool grounded = true;
    if (c.contact_gate != 0.0f) {
      grounded = p_start[3 * leg + 2] < c.contact_gate;
      // End-of-swing target: the sextic at t = 1 is the coefficient sum.
      float pe[3] = {0.0f, 0.0f, 0.0f}, rte[3], pe_rel[3], qe[3];
      for (int k = 0; k < 7; ++k)
        for (int ax = 0; ax < 3; ++ax) pe[ax] = pe[ax] + coef[3 * k + ax];
      for (int ax = 0; ax < 3; ++ax)
        pe[ax] = vmask ? pe[ax] : p_start[3 * leg + ax];
      m3_mtv(rte, R, pe);
      for (int k = 0; k < 3; ++k) pe_rel[k] = rte[k] - x[k] - hip[k];
      qc_ik(c, leg, pe_rel, qe);
      gated = in_stance[leg] && !grounded;
      for (int k = 0; k < 3; ++k) qr[k] = gated ? qe[k] : qr[k];
    }
    eff_stance[leg] = in_stance[leg] && grounded;

    // J^-1 at q_ref: adjugate inverse with the damped fallback.
    float J[9], adj[9], det, JJt[9], adj_d[9], det_d;
    leg_fk_jac(sinf(qr[0]), cosf(qr[0]), sinf(qr[1]), cosf(qr[1]),
               sinf(qr[1] + qr[2]), cosf(qr[1] + qr[2]), c.l1s[leg], c.sl2,
               c.sl3, hip, nullptr, J);
    m3_adj(J, adj, det);
    const bool singular = fabsf(det) <= 1e-8f;
    const float inv_det = 1.0f / (singular ? 1.0f : det);
    for (int a = 0; a < 3; ++a)
      for (int b2 = 0; b2 < 3; ++b2)
        JJt[3 * a + b2] = J[3 * a] * J[3 * b2] + J[3 * a + 1] * J[3 * b2 + 1] +
                          J[3 * a + 2] * J[3 * b2 + 2];
    for (int a = 0; a < 3; ++a) JJt[4 * a] = JJt[4 * a] + 1e-6f;
    m3_adj(JJt, adj_d, det_d);
    const float inv_det_d = 1.0f / det_d;
    for (int a = 0; a < 3; ++a) {
      const float acc_inv = (adj[3 * a] * inv_det) * v_b_ref[0] +
                            (adj[3 * a + 1] * inv_det) * v_b_ref[1] +
                            (adj[3 * a + 2] * inv_det) * v_b_ref[2];
      float acc_d = 0.0f;
      for (int j2 = 0; j2 < 3; ++j2) {
        const float row = J[a] * adj_d[j2] + J[3 + a] * adj_d[3 + j2] +
                          J[6 + a] * adj_d[6 + j2];
        acc_d = acc_d + (row * inv_det_d) * v_b_ref[j2];
      }
      float qdr = singular ? acc_d : acc_inv;
      if (gated) qdr = 0.0f;
      // Swing PD with the reference's exact wrap chain.
      const int idx = 3 * leg + a;
      const float err =
          qc_wrap_pi(qc_wrap_2pi(qr[a]) - qc_wrap_2pi(q[idx]));
      io.tau_swing[(size_t)idx * B + i] =
          c.kp_j[a] * err + c.kd_j[a] * (qdr - qd[idx]) + c.kff_j[a];
      io.q_ref[(size_t)idx * B + i] = qr[a];
    }
  }

  // 9. QP precursors.
  float xddot_d[3], wdot_d[3], E[9], logv[3];
  for (int k = 0; k < 3; ++k)
    xddot_d[k] =
        c.kp_p[k] * (x_d[k] - x[k]) + c.kd_p[k] * (xdot_d[k] - xdot_w[k]);
  xddot_d[0] = xddot_d[0] + c.kff[0] * xdot_d[0];
  xddot_d[1] = xddot_d[1] + c.kff[1] * xdot_d[1];
  xddot_d[2] = xddot_d[2] + c.kff_mg;
  for (int a = 0; a < 3; ++a)
    for (int b2 = 0; b2 < 3; ++b2)
      E[3 * a + b2] = R_d[3 * a] * R[3 * b2] + R_d[3 * a + 1] * R[3 * b2 + 1] +
                      R_d[3 * a + 2] * R[3 * b2 + 2];
  qc_so3_log(E, logv);
  for (int k = 0; k < 3; ++k)
    wdot_d[k] = c.kp_w[k] * logv[k] + c.kd_w[k] * (w_d[k] - w_w[k]);
  wdot_d[0] = wdot_d[0] + c.kff[3] * w_d[0];
  // Reference typo preserved: index 1 takes both kff[4] and kff[5] terms.
  wdot_d[1] = wdot_d[1] + c.kff[4] * w_d[1] + c.kff[5] * w_d[2];

  io.b[(size_t)0 * B + i] = c.mass * xddot_d[0];
  io.b[(size_t)1 * B + i] = c.mass * xddot_d[1];
  io.b[(size_t)2 * B + i] = c.mass * (xddot_d[2] + c.gravity_z);
  {
    float Iw[9], Iw_wdot[3], Iw_wd[3], cr[3];
    for (int a = 0; a < 3; ++a)
      for (int b2 = 0; b2 < 3; ++b2)
        Iw[3 * a + b2] = c.inertia[0] * (R[3 * a] * R[3 * b2]) +
                         c.inertia[1] * (R[3 * a + 1] * R[3 * b2 + 1]) +
                         c.inertia[2] * (R[3 * a + 2] * R[3 * b2 + 2]);
    m3_mv(Iw_wdot, Iw, wdot_d);
    m3_mv(Iw_wd, Iw, w_d);
    v3_cross(cr, w_d, Iw_wd);
    for (int k = 0; k < 3; ++k)
      io.b[(size_t)(3 + k) * B + i] = Iw_wdot[k] + cr[k];
  }
  for (int leg = 0; leg < 4; ++leg) {
    for (int ax = 0; ax < 3; ++ax)
      io.r[(size_t)(3 * leg + ax) * B + i] =
          eff_stance[leg] ? pcom_foot[3 * leg + ax] : 0.0f;
    io.st[(size_t)leg * B + i] = eff_stance[leg] ? 1.0f : 0.0f;
  }
  io.mu[i] = c.mu;
  io.fzmin[i] = c.fz_min;
  io.fzmax[i] = c.fz_max;
  CO[(size_t)QC_STANDING * B] = standing;
  CO[(size_t)QC_GAIT_TIME * B] = gait_time;
  CO[(size_t)QC_INIT * B] = 1.0f;

  // 10. MPC precursor block (control/commander.mpc_precursors): xi0, the
  //     world levers, the N-step stance schedule sampled from the same gait
  //     clock as this tick's stance mask, and the constant-twist reference.
  if (c.mpc_horizon > 0) {
    const int Nh = c.mpc_horizon;
    float* M = io.mpc + i;
    const float r20 = R[6];
    const float roll = atan2f(R[7], R[8]);
    const float pitch = atan2f(-r20, sqrtf(qmax(1.0f - r20 * r20, 0.0f)));
    const float xi0[13] = {roll,     pitch,     yaw,       x[0],      x[1],
                           x[2],     w_w[0],    w_w[1],    w_w[2],    xdot_w[0],
                           xdot_w[1], xdot_w[2], 1.0f};
    for (int k = 0; k < 13; ++k) M[(size_t)k * B] = xi0[k];
    for (int k = 0; k < 12; ++k) M[(size_t)(13 + k) * B] = pcom_foot[k];
    // Schedule: all stance until the gait clock runs; with contact gating,
    // step 0 carries the gated mask.
    for (int t = 0; t < Nh; ++t) {
      const float tk = t_gait + (float)(c.mpc_dt * t);
      for (int leg = 0; leg < 4; ++leg) {
        float ph = c.offsets[leg] + tk * c.inv_period;
        ph = ph - floorf(ph);
        bool stl = (ph <= c.stance_thresh) || !walking;
        if (c.contact_gate != 0.0f && t == 0) stl = stl && eff_stance[leg];
        M[(size_t)(25 + 4 * t + leg) * B] = stl ? 1.0f : 0.0f;
      }
    }
    // Constant-twist reference from cmd_eff = walking ? cmd : 0.
    const float vx = walking ? cmd[0] : 0.0f;
    const float vy = walking ? cmd[1] : 0.0f;
    const float wz = walking ? cmd[5] : 0.0f;
    for (int t = 0; t < Nh; ++t) {
      const float tt = (float)(c.mpc_dt * (t + 1));
      const float ref[13] = {0.0f, 0.0f, yaw + tt * wz, x[0] + tt * vx,
                             x[1] + tt * vy, c.stand_h, 0.0f, 0.0f, wz, vx,
                             vy, 0.0f, 1.0f};
      for (int k = 0; k < 13; ++k)
        M[(size_t)(25 + 4 * Nh + 13 * t + k) * B] = ref[k];
    }
  }
}

// ---------------------------------------------------------------------------
// The lane body: one instance on QC_G lanes, one leg (or two) a lane.
// ---------------------------------------------------------------------------

// What kernels.commander_geometry makes K4's launch from: lanes per
// instance, threads a block.
static inline void qc_layout(int* out) {
  out[0] = QC_G;
  out[1] = QC_THREADS;
}

// Thread t of block blk (QC_THREADS a block): its instance slot and lane.
QCT_DEV void qc_slot(int blk, int t, int& slot, int& lane) {
  lane = t % QC_G;
  slot = blk * (QC_THREADS / QC_G) + t / QC_G;
}

// a[leg * stride] of a parameter array, by selects on uniform loads (no
// lane-dependent index into the parameters).
QCT_DEV float qc_pick4(const float* a, int stride, int leg) {
  return leg == 0   ? a[0]
         : leg == 1 ? a[stride]
         : leg == 2 ? a[2 * stride]
                    : a[3 * stride];
}

// qc_ik without the branch on the leg: the abad angle's atan2f takes the
// mirrored y and the sum is negated by a select (negation is exact, so the
// bits are qc_ik's).
QCT_DEV void qc_ik_sel(const QctCmdParams& c, int leg, const float* p,
                       float* qout) {
  const float x = p[0], y = p[1], z = p[2];
  float d = (x * x + y * y + z * z - c.ik_sum) * c.inv_ik_den;
  d = qclamp(d, -1.0f, 1.0f);
  const float root = sqrtf(qmax(y * y + z * z - c.l1_sq, 0.0f));
  const float neg_l1 = 0.0f - c.l1;
  const bool front = leg < 2;
  const float a0 = atan2f(z, front ? -y : y) + atan2f(root, neg_l1);
  qout[0] = front ? -a0 : a0;
  const float s2v = -sqrtf(qmax(1.0f - d * d, 0.0f));
  qout[2] = atan2f(s2v, d);
  qout[1] = -atan2f(x, root) - atan2f(c.l3 * s2v, c.l2 + c.l3 * d);
}

QCT_DEV void commander_lanes(const QctCmdIO& io, int B, int i,
                             const QctCmdParams& c, int lane) {
  QCT_CLOCK(0);
  const float* S = io.state + i;
  const float* C = io.carry + i;
  float R[9], x[3], w_b[3], v_b[3], cmd[6];
  for (int k = 0; k < 9; ++k) R[k] = S[(size_t)k * B];
  for (int k = 0; k < 3; ++k) {
    x[k] = S[(size_t)(9 + k) * B];
    w_b[k] = S[(size_t)(12 + k) * B];
    v_b[k] = S[(size_t)(15 + k) * B];
  }
  for (int k = 0; k < 6; ++k) cmd[k] = io.cmd[(size_t)k * B + i];

  const float standing0 = C[(size_t)QC_STANDING * B];
  const float gait_time0 = C[(size_t)QC_GAIT_TIME * B];
  const float initialized = C[(size_t)QC_INIT * B];

  // Prefix, in every lane. Measurement: world twist.
  float w_w[3], xdot_w[3];
  m3_mv(w_w, R, w_b);
  m3_mv(xdot_w, R, v_b);

  // 2. Standing latch + gait clock.
  const bool near = fabsf(x[2] - c.stand_h) < c.stand_tol;
  const float standing = qmax(standing0, near ? 1.0f : 0.0f);
  const bool running = gait_time0 >= 0.0f;
  const float gait_time =
      running ? gait_time0 + c.dt : (standing > 0.5f ? 0.0f : gait_time0);
  const bool walking = gait_time >= 0.0f;

  // 3. Desired pose (integrate_twist_yaw under the walking mask).
  float aa[3], v_dt[3], Rbbp[9], tbbp[3];
  for (int k = 0; k < 3; ++k) {
    aa[k] = cmd[3 + k] * c.dt_cmd;
    v_dt[k] = cmd[k] * c.dt_cmd;
  }
  so3_exp_f(aa, Rbbp);
  m3_mv(tbbp, Rbbp, v_dt);
  const float yaw = atan2f(R[3], R[0]);
  const float cy = cosf(yaw), sy = sinf(yaw);
  float R_d[9], x_d[3], xdot_d[3], w_d[3];
  for (int j = 0; j < 3; ++j) {
    const float e0 = (j == 0) ? 1.0f : 0.0f;
    const float e1 = (j == 1) ? 1.0f : 0.0f;
    const float e2 = (j == 2) ? 1.0f : 0.0f;
    R_d[j] = walking ? cy * Rbbp[j] - sy * Rbbp[3 + j] : e0;
    R_d[3 + j] = walking ? sy * Rbbp[j] + cy * Rbbp[3 + j] : e1;
    R_d[6 + j] = walking ? Rbbp[6 + j] : e2;
  }
  x_d[0] = walking ? cy * tbbp[0] - sy * tbbp[1] + x[0] : 0.0f;
  x_d[1] = walking ? sy * tbbp[0] + cy * tbbp[1] + x[1] : 0.0f;
  x_d[2] = c.stand_h;  // height pinned in both branches
  {
    float xw[3], delta[3], lin[3], ang[3];
    v3_cross(xw, x, cmd + 3);
    for (int k = 0; k < 3; ++k) delta[k] = cmd[k] - xw[k];
    m3_mtv(lin, R, delta);
    m3_mtv(ang, R, cmd + 3);
    for (int k = 0; k < 3; ++k) {
      xdot_d[k] = walking ? lin[k] : 0.0f;
      w_d[k] = walking ? ang[k] : 0.0f;
    }
  }
  const float t_gait = qmax(gait_time, 0.0f);

  // 5. The foothold's leg-independent terms.
  const bool init_m = initialized > 0.5f;
  float p_lin[2], p_lip[2];
  const float lip = 0.5f * sqrtf(qmax(x[2], 0.0f) * c.inv_fp_g);
  for (int k = 0; k < 2; ++k) {
    const float v_sym = c.raibert_cmd_symmetric ? xdot_d[k] : xdot_w[k];
    p_lin[k] = c.half_t_stance * v_sym + c.fp_k * (xdot_w[k] - xdot_d[k]);
    p_lip[k] = lip * xdot_w[k];
  }
  QCT_CLOCK(__LINE__);  // prefix

  // The lane's legs: steps 1 and 4-8, then its rows of r, st and the MPC
  // block.
  float* CO = io.carry_out + i;
  float* M = c.mpc_horizon > 0 ? io.mpc + i : nullptr;
  for (int leg = lane; leg < 4; leg += QC_G) {
    // The leg's inputs, all loaded before its first store (a load after a
    // store to a pointer that may alias it waits for the store).
    float hip[3], fp_hip[3], q[3], qd[3], old[21];
    for (int k = 0; k < 21; ++k)
      old[k] = C[(size_t)(QC_COEF + leg * 21 + k) * B];
    const float prev = C[(size_t)(QC_PREV + leg) * B];
    const float valid0 = C[(size_t)(QC_VALID + leg) * B];
    for (int k = 0; k < 3; ++k) {
      hip[k] = qc_pick4(c.hips + k, 3, leg);
      fp_hip[k] = qc_pick4(c.fp_hips + k, 3, leg);
      qd[k] = S[(size_t)(18 + 3 * leg + k) * B];
      q[k] = S[(size_t)(30 + 3 * leg + k) * B];
    }
    const float l1s = qc_pick4(c.l1s, 1, leg);

    // 1. FK.
    float feet_body[3];
    {
      const float s1 = sinf(q[0]), c1 = cosf(q[0]);
      const float s2 = sinf(q[1]), c2 = cosf(q[1]);
      const float s3 = sinf(q[2]), c3 = cosf(q[2]);
      const float s23 = s2 * c3 + c2 * s3;
      const float c23 = c2 * c3 - s2 * s3;
      leg_fk_jac(s1, c1, s2, c2, s23, c23, l1s, c.sl2, c.sl3, hip,
                 feet_body, nullptr);
    }

    // 4. Gait schedule.
    float ph = qc_pick4(c.offsets, 1, leg) + t_gait * c.inv_period;
    ph = ph - floorf(ph);
    const bool in_stance = (ph <= c.stance_thresh) || !walking;
    const float phase = walking ? ph : 0.0f;

    // 5. Foothold planning.
    float pcom_foot[3], p_start[3], foothold[2];
    const bool replan = !in_stance && ((prev > 0.5f) || !init_m);
    m3_mv(pcom_foot, R, feet_body);
    {
      float tang[3];
      v3_cross(tang, w_w, pcom_foot);
      for (int k = 0; k < 2; ++k) {
        const float hip_w = R[3 * k] * fp_hip[0] + R[3 * k + 1] * fp_hip[1] +
                            R[3 * k + 2] * fp_hip[2] + x[k];
        const float fh =
            hip_w + (p_lin[k] + p_lip[k]) + c.half_t_stance * tang[k];
        foothold[k] = replan ? fh : 0.0f;  // z is 0
      }
    }
    for (int k = 0; k < 3; ++k) p_start[k] = pcom_foot[k] + x[k];
    QCT_CLOCK(__LINE__);  // FK, phase, foothold

    // 6. Swing-trajectory replan.
    float coef[21];  // [k][axis]
    const float pc[3] = {0.5f * (p_start[0] + foothold[0]),
                         0.5f * (p_start[1] + foothold[1]), c.swing_height};
    for (int ax = 0; ax < 3; ++ax) {
      const float p0 = p_start[ax];
      const float pf = ax < 2 ? foothold[ax] : 0.0f;
      for (int k = 0; k < 7; ++k) {
        const float nw = c.a_inv[3 * k] * p0 + c.a_inv[3 * k + 1] * pf +
                         c.a_inv[3 * k + 2] * pc[ax];
        const float v = replan ? nw : old[3 * k + ax];
        coef[3 * k + ax] = v;
        QC_STORE(&CO[(size_t)(QC_COEF + leg * 21 + k * 3 + ax) * B], v);
      }
    }
    const float valid = replan ? 1.0f : (valid0 > 0.5f ? 1.0f : 0.0f);
    QC_STORE(&CO[(size_t)(QC_VALID + leg) * B], valid);
    QC_STORE(&CO[(size_t)(QC_PREV + leg) * B], in_stance ? 1.0f : 0.0f);

    // 7. Swing reference on the sextic at the phase's trajectory time.
    const float t = qclamp(c.slope * phase + c.intercept, 0.0f, 1.0f);
    float pw[3] = {0.0f, 0.0f, 0.0f}, vw[3] = {0.0f, 0.0f, 0.0f};
    float tp = 1.0f;
    for (int k = 0; k < 7; ++k) {
      for (int ax = 0; ax < 3; ++ax) pw[ax] = pw[ax] + coef[3 * k + ax] * tp;
      tp = tp * t;
    }
    tp = 1.0f;
    for (int k = 1; k < 7; ++k) {
      for (int ax = 0; ax < 3; ++ax)
        vw[ax] = vw[ax] + (float)k * coef[3 * k + ax] * tp;
      tp = tp * t;
    }
    const bool vmask = valid > 0.5f;
    for (int ax = 0; ax < 3; ++ax) {
      pw[ax] = vmask ? pw[ax] : 0.0f;
      vw[ax] = vmask ? vw[ax] : 0.0f;
    }
    QCT_CLOCK(__LINE__);  // sextic replan and evaluation

    // p_b = R^T p_w - x (the reference's quirk), then hip-relative; IK.
    float rtp[3], p_rel[3], v_b_ref[3], qr[3];
    m3_mtv(rtp, R, pw);
    for (int k = 0; k < 3; ++k) p_rel[k] = rtp[k] - x[k] - hip[k];
    m3_mtv(v_b_ref, R, vw);
    qc_ik_sel(c, leg, p_rel, qr);

    bool gated = false;
    bool grounded = true;
    if (c.contact_gate != 0.0f) {
      grounded = p_start[2] < c.contact_gate;
      // End-of-swing target: the sextic at t = 1 is the coefficient sum.
      float pe[3] = {0.0f, 0.0f, 0.0f}, rte[3], pe_rel[3], qe[3];
      for (int k = 0; k < 7; ++k)
        for (int ax = 0; ax < 3; ++ax) pe[ax] = pe[ax] + coef[3 * k + ax];
      for (int ax = 0; ax < 3; ++ax) pe[ax] = vmask ? pe[ax] : p_start[ax];
      m3_mtv(rte, R, pe);
      for (int k = 0; k < 3; ++k) pe_rel[k] = rte[k] - x[k] - hip[k];
      qc_ik_sel(c, leg, pe_rel, qe);
      gated = in_stance && !grounded;
      for (int k = 0; k < 3; ++k) qr[k] = gated ? qe[k] : qr[k];
    }
    const bool eff_stance = in_stance && grounded;
    QCT_CLOCK(__LINE__);  // IK, gated end-of-swing IK

    // 8. J^-1 at q_ref: adjugate inverse with the damped fallback; swing PD.
    float J[9], adj[9], det, JJt[9], adj_d[9], det_d;
    leg_fk_jac(sinf(qr[0]), cosf(qr[0]), sinf(qr[1]), cosf(qr[1]),
               sinf(qr[1] + qr[2]), cosf(qr[1] + qr[2]), l1s, c.sl2, c.sl3,
               hip, nullptr, J);
    m3_adj(J, adj, det);
    const bool singular = fabsf(det) <= 1e-8f;
    const float inv_det = 1.0f / (singular ? 1.0f : det);
    for (int a = 0; a < 3; ++a)
      for (int b2 = 0; b2 < 3; ++b2)
        JJt[3 * a + b2] = J[3 * a] * J[3 * b2] + J[3 * a + 1] * J[3 * b2 + 1] +
                          J[3 * a + 2] * J[3 * b2 + 2];
    for (int a = 0; a < 3; ++a) JJt[4 * a] = JJt[4 * a] + 1e-6f;
    m3_adj(JJt, adj_d, det_d);
    const float inv_det_d = 1.0f / det_d;
    for (int a = 0; a < 3; ++a) {
      const float acc_inv = (adj[3 * a] * inv_det) * v_b_ref[0] +
                            (adj[3 * a + 1] * inv_det) * v_b_ref[1] +
                            (adj[3 * a + 2] * inv_det) * v_b_ref[2];
      float acc_d = 0.0f;
      for (int j2 = 0; j2 < 3; ++j2) {
        const float row = J[a] * adj_d[j2] + J[3 + a] * adj_d[3 + j2] +
                          J[6 + a] * adj_d[6 + j2];
        acc_d = acc_d + (row * inv_det_d) * v_b_ref[j2];
      }
      float qdr = singular ? acc_d : acc_inv;
      qdr = gated ? 0.0f : qdr;
      const int idx = 3 * leg + a;
      const float err = qc_wrap_pi(qc_wrap_2pi(qr[a]) - qc_wrap_2pi(q[a]));
      QC_STORE(&io.tau_swing[(size_t)idx * B + i],
               c.kp_j[a] * err + c.kd_j[a] * (qdr - qd[a]) + c.kff_j[a]);
      QC_STORE(&io.q_ref[(size_t)idx * B + i], qr[a]);
    }

    // The leg's rows of the QP levers and stance mask.
    for (int ax = 0; ax < 3; ++ax)
      QC_STORE(&io.r[(size_t)(3 * leg + ax) * B + i],
               eff_stance ? pcom_foot[ax] : 0.0f);
    QC_STORE(&io.st[(size_t)leg * B + i], eff_stance ? 1.0f : 0.0f);
    // ... and of the MPC block: its levers and its schedule column (all
    // stance until the gait clock runs; with contact gating, step 0 carries
    // the gated mask).
    if (c.mpc_horizon > 0) {
      for (int ax = 0; ax < 3; ++ax)
        QC_STORE(&M[(size_t)(13 + 3 * leg + ax) * B], pcom_foot[ax]);
      const float off = qc_pick4(c.offsets, 1, leg);
      for (int tt = 0; tt < c.mpc_horizon; ++tt) {
        const float tk = t_gait + (float)(c.mpc_dt * tt);
        float phk = off + tk * c.inv_period;
        phk = phk - floorf(phk);
        bool stl = (phk <= c.stance_thresh) || !walking;
        if (c.contact_gate != 0.0f && tt == 0) stl = stl && eff_stance;
        QC_STORE(&M[(size_t)(25 + 4 * tt + leg) * B], stl ? 1.0f : 0.0f);
      }
    }
    QCT_CLOCK(__LINE__);  // J^-1, swing PD, the leg's outputs
  }

  // 9. QP precursors (lane 0).
  if (lane == 0) {
    float xddot_d[3], wdot_d[3], E[9], logv[3];
    for (int k = 0; k < 3; ++k)
      xddot_d[k] =
          c.kp_p[k] * (x_d[k] - x[k]) + c.kd_p[k] * (xdot_d[k] - xdot_w[k]);
    xddot_d[0] = xddot_d[0] + c.kff[0] * xdot_d[0];
    xddot_d[1] = xddot_d[1] + c.kff[1] * xdot_d[1];
    xddot_d[2] = xddot_d[2] + c.kff_mg;
    for (int a = 0; a < 3; ++a)
      for (int b2 = 0; b2 < 3; ++b2)
        E[3 * a + b2] = R_d[3 * a] * R[3 * b2] +
                        R_d[3 * a + 1] * R[3 * b2 + 1] +
                        R_d[3 * a + 2] * R[3 * b2 + 2];
    qc_so3_log(E, logv);
    for (int k = 0; k < 3; ++k)
      wdot_d[k] = c.kp_w[k] * logv[k] + c.kd_w[k] * (w_d[k] - w_w[k]);
    wdot_d[0] = wdot_d[0] + c.kff[3] * w_d[0];
    // Reference typo preserved: index 1 takes both kff[4] and kff[5] terms.
    wdot_d[1] = wdot_d[1] + c.kff[4] * w_d[1] + c.kff[5] * w_d[2];

    QC_STORE(&io.b[(size_t)0 * B + i], c.mass * xddot_d[0]);
    QC_STORE(&io.b[(size_t)1 * B + i], c.mass * xddot_d[1]);
    QC_STORE(&io.b[(size_t)2 * B + i], c.mass * (xddot_d[2] + c.gravity_z));
    float Iw[9], Iw_wdot[3], Iw_wd[3], cr[3];
    for (int a = 0; a < 3; ++a)
      for (int b2 = 0; b2 < 3; ++b2)
        Iw[3 * a + b2] = c.inertia[0] * (R[3 * a] * R[3 * b2]) +
                         c.inertia[1] * (R[3 * a + 1] * R[3 * b2 + 1]) +
                         c.inertia[2] * (R[3 * a + 2] * R[3 * b2 + 2]);
    m3_mv(Iw_wdot, Iw, wdot_d);
    m3_mv(Iw_wd, Iw, w_d);
    v3_cross(cr, w_d, Iw_wd);
    for (int k = 0; k < 3; ++k)
      QC_STORE(&io.b[(size_t)(3 + k) * B + i], Iw_wdot[k] + cr[k]);
    QC_STORE(&io.mu[i], c.mu);
    QC_STORE(&io.fzmin[i], c.fz_min);
    QC_STORE(&io.fzmax[i], c.fz_max);
    QC_STORE(&CO[(size_t)QC_STANDING * B], standing);
    QC_STORE(&CO[(size_t)QC_GAIT_TIME * B], gait_time);
    QC_STORE(&CO[(size_t)QC_INIT * B], 1.0f);
  }
  QCT_CLOCK(__LINE__);  // right-hand side b, scalar outputs

  // 10. The MPC block's xi0 (lane 1 % QC_G) and its constant-twist
  //     reference from cmd_eff = walking ? cmd : 0 (step t in lane t %
  //     QC_G).
  if (c.mpc_horizon > 0) {
    const int Nh = c.mpc_horizon;
    if (lane == 1 % QC_G) {
      const float r20 = R[6];
      const float roll = atan2f(R[7], R[8]);
      const float pitch = atan2f(-r20, sqrtf(qmax(1.0f - r20 * r20, 0.0f)));
      const float xi0[13] = {roll,      pitch,     yaw,       x[0],
                             x[1],      x[2],      w_w[0],    w_w[1],
                             w_w[2],    xdot_w[0], xdot_w[1], xdot_w[2],
                             1.0f};
      for (int k = 0; k < 13; ++k) QC_STORE(&M[(size_t)k * B], xi0[k]);
    }
    const float vx = walking ? cmd[0] : 0.0f;
    const float vy = walking ? cmd[1] : 0.0f;
    const float wz = walking ? cmd[5] : 0.0f;
    for (int t = lane; t < Nh; t += QC_G) {
      const float tt = (float)(c.mpc_dt * (t + 1));
      const float ref[13] = {0.0f, 0.0f, yaw + tt * wz, x[0] + tt * vx,
                             x[1] + tt * vy, c.stand_h, 0.0f, 0.0f, wz, vx,
                             vy, 0.0f, 1.0f};
      for (int k = 0; k < 13; ++k)
        QC_STORE(&M[(size_t)(25 + 4 * Nh + 13 * t + k) * B], ref[k]);
    }
    QCT_CLOCK(__LINE__);  // MPC block: xi0, reference
  }
}
