// K6's serial body: the whole receding-horizon SRB-MPC solve, one robot per
// thread. This is the body K6 ran before it was split over lanes (the kernel
// of its first port); kernels.mpc_serial launches it as qct_mpc_serial. No
// path of the port launches it: it is the bitwise hold of the lane kernel
// (qct_mpc.cuh's mpc_instance), whose every element keeps this body's
// operation order, so the two must agree bit for bit on the card and in
// the host build (tests/test_torch_mpc_lanes.py, chip_smoke.py).
//
// What it computes is the lane kernel's (see qct_mpc.cuh). Memory: the
// fixed-size matrices of the sweep (P, P A, P B, Lux: 650 words; the LDL
// factor: 90) are per-thread local arrays; everything whose size grows with
// the horizon N (324 words per step) lives in a wrapper-allocated global
// scratch laid out (324 N, B): component j of robot i at scratch[j * B + i].
// The arguments (QctMpcIO, QctMpcParams) are the lane kernel's; the scratch
// alone has another layout. Inside namespace qmpc_serial so that its helpers
// sit beside the lane kernel's in one translation unit.
//
// NaN. Every max/min goes through qmax/qmin (qct_common.cuh), which
// propagate NaN as torch.maximum does; a poisoned robot stays poisoned in its
// own thread and nowhere else.
#pragma once

#include "qct_mpc.cuh"

namespace qmpc_serial {

// Component view of one instance in a (k, B) array.
struct QLane {
  float* p;
  size_t s;
  QCT_MEM float& operator[](int j) const { return p[(size_t)j * s]; }
};
struct QLaneC {
  const float* p;
  size_t s;
  QCT_MEM float operator[](int j) const { return p[(size_t)j * s]; }
};

QCT_DEV int mtri(int i, int j) { return (i * (i + 1)) / 2 + j; }

// A v with A = I + dt S (S sparse, mpc/horizon.srb_discrete_dynamics).
QCT_DEV void mpc_amv(const float* v, float* o, float cy, float sy, float dt,
                     float g_dt) {
  for (int k = 0; k < QMPC_NX; ++k) o[k] = v[k];
  o[0] = v[0] + dt * (cy * v[6] + sy * v[7]);
  o[1] = v[1] + dt * (-sy * v[6] + cy * v[7]);
  o[2] = v[2] + dt * v[8];
  o[3] = v[3] + dt * v[9];
  o[4] = v[4] + dt * v[10];
  o[5] = v[5] + dt * v[11];
  o[11] = v[11] - g_dt * v[12];
}

// A^T v.
QCT_DEV void mpc_atmv(const float* v, float* o, float cy, float sy, float dt,
                      float g_dt) {
  for (int k = 0; k < QMPC_NX; ++k) o[k] = v[k];
  o[6] = v[6] + dt * (cy * v[0] - sy * v[1]);
  o[7] = v[7] + dt * (sy * v[0] + cy * v[1]);
  o[8] = v[8] + dt * v[2];
  o[9] = v[9] + dt * v[3];
  o[10] = v[10] + dt * v[4];
  o[11] = v[11] + dt * v[5];
  o[12] = v[12] - g_dt * v[11];
}

// B_t u: Bw[9 l + 3 c + a] lever blocks (rows 6-8), bm diagonal (rows 9-11),
// column block l masked by mk[l].
QCT_DEV void mpc_bmv(const float* u, const float* mk, const float* Bw,
                     float bm, float* o) {
  float um[QMPC_NU];
  for (int l = 0; l < 4; ++l)
    for (int a = 0; a < 3; ++a) um[3 * l + a] = mk[l] * u[3 * l + a];
  for (int k = 0; k < QMPC_NX; ++k) o[k] = 0.0f;
  for (int l = 0; l < 4; ++l)
    for (int c = 0; c < 3; ++c) {
      float acc = o[6 + c];
      for (int a = 0; a < 3; ++a) acc = acc + Bw[9 * l + 3 * c + a] * um[3 * l + a];
      o[6 + c] = acc;
    }
  for (int a = 0; a < 3; ++a) {
    float acc = o[9 + a];
    for (int l = 0; l < 4; ++l) acc = acc + bm * um[3 * l + a];
    o[9 + a] = acc;
  }
}

// B_t^T v.
QCT_DEV void mpc_btmv(const float* v, const float* mk, const float* Bw,
                      float bm, float* o) {
  for (int l = 0; l < 4; ++l)
    for (int a = 0; a < 3; ++a) {
      float acc = bm * v[9 + a];
      for (int c = 0; c < 3; ++c) acc = acc + Bw[9 * l + 3 * c + a] * v[6 + c];
      o[3 * l + a] = mk[l] * acc;
    }
}

// Scaled cone rows of one leg: row ty of leg l acts on u[3l .. 3l+2].
//   ty 0:  sf u0 + gmu u2     ty 1:  sf u1 + gmu u2    ty 2: -sf u1 + gmu u2
//   ty 3: -sf u0 + gmu u2     ty 4:  sf u2             ty 5: -sf u2
// with gmu = -sf mu. g_entry gives the coefficient of leg-local column a in
// row ty (0 where the row does not touch it).
QCT_DEV float mpc_g_entry(int ty, int a, float sf, float gmu, bool& present) {
  present = true;
  if (a == 2) {
    if (ty < 4) return gmu;
    return ty == 4 ? sf : -sf;
  }
  if (a == 0 && ty == 0) return sf;
  if (a == 0 && ty == 3) return -sf;
  if (a == 1 && ty == 1) return sf;
  if (a == 1 && ty == 2) return -sf;
  present = false;
  return 0.0f;
}

QCT_DEV float mpc_gx_row(const float* u, int rr, float sf, float gmu) {
  const int leg = rr / 6, ty = rr - 6 * leg;
  const float* ul = u + 3 * leg;
  switch (ty) {
    case 0: return sf * ul[0] + gmu * ul[2];
    case 1: return sf * ul[1] + gmu * ul[2];
    case 2: return -sf * ul[1] + gmu * ul[2];
    case 3: return -sf * ul[0] + gmu * ul[2];
    case 4: return sf * ul[2];
    default: return -sf * ul[2];
  }
}

// (G^T zv)_i for the 24 cone rows zv of one step.
QCT_DEV float mpc_gty_col(const float* zv, int i, float sf, float gmu) {
  const int leg = i / 3, a = i - 3 * leg;
  const float* z = zv + 6 * leg;
  if (a == 0) return sf * z[0] + -sf * z[3];
  if (a == 1) return sf * z[1] + -sf * z[2];
  return gmu * z[0] + gmu * z[1] + gmu * z[2] + gmu * z[3] + sf * z[4] +
         -sf * z[5];
}

// Solve Luu x = v with the packed unit-lower L and the pivots D.
QCT_DEV void mpc_ldl_solve(const float* L, const float* D, const float* v,
                           float* out) {
  float y[QMPC_NU];
  for (int i = 0; i < QMPC_NU; ++i) {
    float acc = v[i];
    for (int k = 0; k < i; ++k) acc = acc - L[mtri(i, k)] * y[k];
    y[i] = acc;
  }
  for (int i = QMPC_NU - 1; i >= 0; --i) {
    float acc = y[i] / D[i];
    for (int k = i + 1; k < QMPC_NU; ++k) acc = acc - L[mtri(k, i)] * out[k];
    out[i] = acc;
  }
}

QCT_DEV void mpc_instance(const QctMpcIO& io, int B, int i,
                          const QctMpcParams& p) {
  const int N = p.n_steps;
  const size_t sB = (size_t)B;
  const float eps = Q_EPS;
  const float d_max = 1.0f / eps;
  const float big = Q_BIG;
  const float tiny = 1e-12f;
  const float sf = p.sf;
  const float dt = p.dt, g_dt = p.g_dt;

  const QLaneC blk{io.block + i, sB};
  float* base = io.scratch + i;
  const size_t n = (size_t)N;
  const QLane Fs{base, sB};
  const QLane ss{base + 12 * n * sB, sB};
  const QLane zs{base + 36 * n * sB, sB};
  const QLane rp{base + 60 * n * sB, sB};
  const QLane rd{base + 84 * n * sB, sB};
  const QLane dF{base + 96 * n * sB, sB};
  const QLane cs{base + 108 * n * sB, sB};
  const QLane hs{base + 120 * n * sB, sB};
  const QLane bF{base + 144 * n * sB, sB};
  const QLane kst{base + 156 * n * sB, sB};
  const QLane Ks{base + 168 * n * sB, sB};  // K_t[u][j] at t*156 + u*13 + j

  // ---- inputs ------------------------------------------------------------
  float m, Ib[3], mu, fzmin, fzmax;
  if (io.phys) {
    const QLaneC ph{io.phys + i, sB};
    m = ph[0];
    Ib[0] = ph[1];
    Ib[1] = ph[2];
    Ib[2] = ph[3];
    mu = ph[4];
    fzmin = ph[5];
    fzmax = ph[6];
  } else {
    m = p.mass;
    Ib[0] = p.inertia[0];
    Ib[1] = p.inertia[1];
    Ib[2] = p.inertia[2];
    mu = p.mu;
    fzmin = p.fz_min;
    fzmax = p.fz_max;
  }
  float xi0[QMPC_NX], r[12];
  for (int k = 0; k < QMPC_NX; ++k) xi0[k] = blk[k];
  for (int k = 0; k < 12; ++k) r[k] = blk[QMPC_NX + k];
  const float yaw = io.yaw ? io.yaw[i] : xi0[2];
  const int off_st = 25, off_ref = 25 + 4 * N;
  auto masks = [&](int t, float* mk) {
    for (int l = 0; l < 4; ++l) mk[l] = blk[off_st + 4 * t + l];
  };

  // ---- dynamics data: Iw^-1 by adjugate, lever blocks ---------------------
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float Ixx = cy * cy * Ib[0] + sy * sy * Ib[1];
  const float Ixy = cy * sy * (Ib[0] - Ib[1]);
  const float Iyy = sy * sy * Ib[0] + cy * cy * Ib[1];
  const float Izz = Ib[2];
  const float det2 = Ixx * Iyy - Ixy * Ixy;
  const float inv2 = 1.0f / det2;
  const float W[9] = {Iyy * inv2, -Ixy * inv2, 0.0f,
                      -Ixy * inv2, Ixx * inv2, 0.0f,
                      0.0f, 0.0f, 1.0f / Izz};
  float Bw[36];
  for (int l = 0; l < 4; ++l) {
    const float x_ = r[3 * l], y_ = r[3 * l + 1], z_ = r[3 * l + 2];
    const float sk[9] = {0.0f, -z_, y_, z_, 0.0f, -x_, -y_, x_, 0.0f};
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 3; ++a) {
        const float v = W[3 * c] * sk[a] + W[3 * c + 1] * sk[3 + a] +
                        W[3 * c + 2] * sk[6 + a];
        Bw[9 * l + 3 * c + a] = p.sfdt * v;
      }
  }
  const float bm = p.sfdt / m;
  const float gmu = -sf * mu;

  // ---- cone bounds -------------------------------------------------------
  const float hb[6] = {0.0f, 0.0f, 0.0f, 0.0f, fzmax, -fzmin};
  for (int t = 0; t < N; ++t)
    for (int l = 0; l < 4; ++l) {
      const bool stl = blk[off_st + 4 * t + l] > 0.5f;
      for (int ty = 0; ty < 6; ++ty)
        hs[t * QMPC_MC + 6 * l + ty] = stl ? hb[ty] : p.relax;
    }

  // ---- linear cost c' = 2 nu B'^T L (A^t xi0 - ref) ------------------------
  {
    float xi[QMPC_NX], xi1[QMPC_NX];
    for (int k = 0; k < QMPC_NX; ++k) xi[k] = xi0[k];
    for (int t = 0; t < N; ++t) {
      mpc_amv(xi, xi1, cy, sy, dt, g_dt);
      for (int k = 0; k < QMPC_NX; ++k) {
        rp[t * QMPC_MC + k] = p.w[k] * (xi1[k] - blk[off_ref + QMPC_NX * t + k]);
        xi[k] = xi1[k];
      }
    }
    float lam[QMPC_NX], lam_t[QMPC_NX], cb[QMPC_NU], mk[4];
    for (int k = 0; k < QMPC_NX; ++k) lam[k] = 0.0f;
    for (int t = N - 1; t >= 0; --t) {
      for (int k = 0; k < QMPC_NX; ++k) lam_t[k] = rp[t * QMPC_MC + k] + lam[k];
      masks(t, mk);
      mpc_btmv(lam_t, mk, Bw, bm, cb);
      for (int u = 0; u < QMPC_NU; ++u) cs[t * QMPC_NU + u] = 2.0f * cb[u];
      mpc_atmv(lam_t, lam, cy, sy, dt, g_dt);
    }
  }
  float cmax = 0.0f;
  for (int k = 0; k < N * QMPC_NU; ++k) cmax = qmax(cmax, fabsf(cs[k]));
  const float nu = 1.0f / qmax(cmax, 1e-12f);
  for (int k = 0; k < N * QMPC_NU; ++k) cs[k] = cs[k] * nu;
  const float q_scale = 2.0f * nu;
  const float r_diag = 2.0f * nu * p.r_alpha;
  float hmax = 0.0f;
  for (int k = 0; k < N * QMPC_MC; ++k) hmax = qmax(hmax, fabsf(hs[k]));
  const float obj_scale = 2.0f;  // max |c'| = 1 by construction
  const float h_scale = 1.0f + hmax;

  // rd <- H' F for F in Fs (rp is the forward pass's temporary).
  auto hvp_into_rd = [&]() {
    float xi[QMPC_NX], xi1[QMPC_NX], bu[QMPC_NX], u[QMPC_NU], mk[4];
    for (int k = 0; k < QMPC_NX; ++k) xi[k] = 0.0f;
    for (int t = 0; t < N; ++t) {
      for (int k = 0; k < QMPC_NU; ++k) u[k] = Fs[t * QMPC_NU + k];
      masks(t, mk);
      mpc_amv(xi, xi1, cy, sy, dt, g_dt);
      mpc_bmv(u, mk, Bw, bm, bu);
      for (int k = 0; k < QMPC_NX; ++k) {
        xi[k] = xi1[k] + bu[k];
        rp[t * QMPC_MC + k] = q_scale * p.w[k] * xi[k];
      }
    }
    float lam[QMPC_NX], lam_t[QMPC_NX], hb_[QMPC_NU];
    for (int k = 0; k < QMPC_NX; ++k) lam[k] = 0.0f;
    for (int t = N - 1; t >= 0; --t) {
      for (int k = 0; k < QMPC_NX; ++k) lam_t[k] = rp[t * QMPC_MC + k] + lam[k];
      masks(t, mk);
      mpc_btmv(lam_t, mk, Bw, bm, hb_);
      for (int k = 0; k < QMPC_NU; ++k)
        rd[t * QMPC_NU + k] = hb_[k] + r_diag * Fs[t * QMPC_NU + k];
      mpc_atmv(lam_t, lam, cy, sy, dt, g_dt);
    }
  };

  // rd <- H' F + c' + G^T z, rp <- G F + s - h; returns pr, dr, gap (sum).
  auto residuals = [&](float& pr, float& dr, float& gap) {
    hvp_into_rd();
    float u[QMPC_NU], zv[QMPC_MC];
    for (int t = 0; t < N; ++t) {
      for (int k = 0; k < QMPC_NU; ++k) u[k] = Fs[t * QMPC_NU + k];
      for (int rr = 0; rr < QMPC_MC; ++rr) zv[rr] = zs[t * QMPC_MC + rr];
      for (int k = 0; k < QMPC_NU; ++k)
        rd[t * QMPC_NU + k] =
            rd[t * QMPC_NU + k] + cs[t * QMPC_NU + k] + mpc_gty_col(zv, k, sf, gmu);
      for (int rr = 0; rr < QMPC_MC; ++rr)
        rp[t * QMPC_MC + rr] = mpc_gx_row(u, rr, sf, gmu) +
                               ss[t * QMPC_MC + rr] - hs[t * QMPC_MC + rr];
    }
    pr = 0.0f;
    gap = 0.0f;
    for (int k = 0; k < N * QMPC_MC; ++k) {
      pr = qmax(pr, fabsf(rp[k]));
      gap = gap + ss[k] * zs[k];
    }
    dr = 0.0f;
    for (int k = 0; k < N * QMPC_NU; ++k) dr = qmax(dr, fabsf(rd[k]));
  };

  // ---- start point ---------------------------------------------------------
  const bool track_best = p.track_best != 0;
  if (!io.warm_F) {
    for (int k = 0; k < N * QMPC_MC; ++k) {
      const float s0 = qmax(hs[k], 1.0f);
      ss[k] = s0;
      zs[k] = 1.0f / s0;
    }
    for (int k = 0; k < N * QMPC_NU; ++k) {
      Fs[k] = 0.0f;
      if (track_best) bF[k] = 0.0f;
    }
  } else {
    // Warm start from the previous tick's horizon solution, in ORIGINAL
    // units (F in Newtons, z unscaled: rescaled by this tick's nu). A
    // (step, leg) whose schedule bit changed resets cold; a schedule of -1
    // resets everything (the first tick is exactly the cold start).
    const QLaneC Fw{io.warm_F + i, sB};
    const QLaneC szw{io.warm_sz + i, sB};
    const QLaneC stw{io.warm_sched + i, sB};
    const float interior = 1e-2f;
    const float inv_sf = 1.0f / sf;
    for (int k = 0; k < N * QMPC_MC; ++k) {
      const int t = k / QMPC_MC, leg = (k - t * QMPC_MC) / 6;
      const bool changed =
          fabsf(blk[off_st + 4 * t + leg] - stw[4 * t + leg]) > 0.5f;
      const float s_cold = qmax(hs[k], 1.0f);
      const float s_warm = qmax(szw[k], interior);
      // Floor the complementarity product, not z: swing rows have s ~ 1e4,
      // and an absolute z floor would inject s z ~ 100 there.
      const float z_warm = qmax(szw[N * QMPC_MC + k] * nu, interior / s_warm);
      ss[k] = changed ? s_cold : s_warm;
      zs[k] = changed ? 1.0f / s_cold : z_warm;
    }
    for (int k = 0; k < N * QMPC_NU; ++k) {
      const int t = k / QMPC_NU, leg = (k - t * QMPC_NU) / 3;
      const float stc = blk[off_st + 4 * t + leg];
      const bool keep = fabsf(stc - stw[4 * t + leg]) < 0.5f && stc > 0.5f;
      Fs[k] = keep ? Fw[k] * inv_sf : 0.0f;
      if (track_best) bF[k] = Fs[k];
    }
  }

  // ---- the interior-point iterations -----------------------------------------
  float P[QMPC_NX * QMPC_NX], PA[QMPC_NX * QMPC_NX];
  float PB[QMPC_NX * QMPC_NU], Lux[QMPC_NU * QMPC_NX];
  float Lf[78], Df[QMPC_NU];
  float best_merit = 3.0e38f;
  bool frozen = false;
  float a_prev = 0.0f;
  const float inv_nmc = 1.0f / (float)(N * QMPC_MC);
  for (int it = 0; it < p.iterations; ++it) {
    float pr, dr, gap;
    residuals(pr, dr, gap);
    const float mu_avg = gap * inv_nmc;
    const float merit = pr / h_scale + dr / obj_scale + mu_avg / obj_scale;
    const bool improve = merit < best_merit;
    if (track_best && improve)
      for (int k = 0; k < N * QMPC_NU; ++k) bF[k] = Fs[k];
    best_merit = improve ? merit : best_merit;
    const bool done = (mu_avg < (100.0f * eps) * obj_scale) &&
                      (pr < (50.0f * eps) * h_scale) &&
                      (dr < (50.0f * eps) * obj_scale);
    // Adaptive centering: long previous steps aim low, short ones re-center.
    const float om = 1.0f - a_prev;
    const float sig = qmin(qmax(om * om * om, 0.03f), p.sigma_c);
    const float rc = sig * mu_avg;

    // rhs_t = -rd_t - G^T [(z rp - (s z - rc)) / s] into dF.
    for (int t = 0; t < N; ++t) {
      float tv[QMPC_MC];
      for (int rr = 0; rr < QMPC_MC; ++rr) {
        const float sv = ss[t * QMPC_MC + rr], zv = zs[t * QMPC_MC + rr];
        tv[rr] = (zv * rp[t * QMPC_MC + rr] - (sv * zv - rc)) / sv;
      }
      for (int k = 0; k < QMPC_NU; ++k)
        dF[t * QMPC_NU + k] = -rd[t * QMPC_NU + k] - mpc_gty_col(tv, k, sf, gmu);
    }

    // Backward Riccati sweep: P_N = 2 nu diag(L), p_N = 0.
    for (int a = 0; a < QMPC_NX; ++a)
      for (int b = 0; b < QMPC_NX; ++b)
        P[QMPC_NX * a + b] = a == b ? q_scale * p.w[a] : 0.0f;
    float pv[QMPC_NX];
    for (int k = 0; k < QMPC_NX; ++k) pv[k] = 0.0f;
    for (int t = N - 1; t >= 0; --t) {
      float mk[4];
      masks(t, mk);
      // PB = P B_t.
      for (int u = 0; u < QMPC_NU; ++u) {
        const int l = u / 3, a = u - 3 * l;
        for (int k = 0; k < QMPC_NX; ++k) {
          float acc = P[QMPC_NX * k + 9 + a] * bm;
          for (int c = 0; c < 3; ++c)
            acc = acc + P[QMPC_NX * k + 6 + c] * Bw[9 * l + 3 * c + a];
          PB[QMPC_NU * k + u] = acc * mk[l];
        }
      }
      // Luu = B^T P B + r_diag I + G^T D G (packed lower), then + reg I.
      float dv[QMPC_MC];
      for (int rr = 0; rr < QMPC_MC; ++rr)
        dv[rr] = qmin(zs[t * QMPC_MC + rr] / ss[t * QMPC_MC + rr], d_max);
      for (int a1 = 0; a1 < QMPC_NU; ++a1) {
        const int li = a1 / 3, a = a1 - 3 * li;
        for (int b1 = 0; b1 <= a1; ++b1) {
          const int lj = b1 / 3, b = b1 - 3 * lj;
          float acc = mk[li] * (bm * PB[QMPC_NU * (9 + a) + b1]);
          for (int c = 0; c < 3; ++c)
            acc = acc + mk[li] * Bw[9 * li + 3 * c + a] * PB[QMPC_NU * (6 + c) + b1];
          if (a1 == b1) acc = acc + r_diag;
          if (li == lj) {
            for (int ty = 0; ty < 6; ++ty) {
              bool pa, pb;
              const float ga = mpc_g_entry(ty, a, sf, gmu, pa);
              const float gb = mpc_g_entry(ty, b, sf, gmu, pb);
              if (pa && pb) acc = acc + ga * dv[6 * li + ty] * gb;
            }
          }
          Lf[mtri(a1, b1)] = acc;
        }
      }
      float dmx = Lf[mtri(0, 0)];
      for (int a1 = 1; a1 < QMPC_NU; ++a1) dmx = qmax(dmx, Lf[mtri(a1, a1)]);
      const float reg = (100.0f * eps) * dmx;
      for (int a1 = 0; a1 < QMPC_NU; ++a1)
        Lf[mtri(a1, a1)] = Lf[mtri(a1, a1)] + reg;
      // Packed LDL^T; a pivot with |d| <= 1e-30 becomes NaN (poisons the
      // step, which the finite gate then rejects).
      for (int j = 0; j < QMPC_NU; ++j) {
        float dd = Lf[mtri(j, j)];
        for (int k = 0; k < j; ++k)
          dd = dd - Lf[mtri(j, k)] * Lf[mtri(j, k)] * Df[k];
        dd = fabsf(dd) > 1e-30f ? dd : qnan();
        Df[j] = dd;
        const float dinv = 1.0f / dd;
        for (int a1 = j + 1; a1 < QMPC_NU; ++a1) {
          float v = Lf[mtri(a1, j)];
          for (int k = 0; k < j; ++k)
            v = v - Lf[mtri(a1, k)] * Df[k] * Lf[mtri(j, k)];
          Lf[mtri(a1, j)] = v * dinv;
        }
      }
      // PA = P A (A = I + dt S), Lux = B^T P A.
      for (int k = 0; k < QMPC_NX; ++k) {
        const float* Pk = P + QMPC_NX * k;
        for (int j = 0; j < QMPC_NX; ++j) PA[QMPC_NX * k + j] = Pk[j];
        PA[QMPC_NX * k + 6] = Pk[6] + dt * (Pk[0] * cy - Pk[1] * sy);
        PA[QMPC_NX * k + 7] = Pk[7] + dt * (Pk[0] * sy + Pk[1] * cy);
        PA[QMPC_NX * k + 8] = Pk[8] + dt * Pk[2];
        PA[QMPC_NX * k + 9] = Pk[9] + dt * Pk[3];
        PA[QMPC_NX * k + 10] = Pk[10] + dt * Pk[4];
        PA[QMPC_NX * k + 11] = Pk[11] + dt * Pk[5];
        PA[QMPC_NX * k + 12] = Pk[12] - g_dt * Pk[11];
      }
      for (int a1 = 0; a1 < QMPC_NU; ++a1) {
        const int li = a1 / 3, a = a1 - 3 * li;
        for (int j = 0; j < QMPC_NX; ++j) {
          float acc = bm * PA[QMPC_NX * (9 + a) + j];
          for (int c = 0; c < 3; ++c)
            acc = acc + Bw[9 * li + 3 * c + a] * PA[QMPC_NX * (6 + c) + j];
          Lux[QMPC_NX * a1 + j] = mk[li] * acc;
        }
      }
      // Gains K_t = -Luu^-1 Lux, column by column, into the scratch.
      const int kb = t * QMPC_NU * QMPC_NX;
      for (int j = 0; j < QMPC_NX; ++j) {
        float v[QMPC_NU], sol[QMPC_NU];
        for (int a1 = 0; a1 < QMPC_NU; ++a1) v[a1] = Lux[QMPC_NX * a1 + j];
        mpc_ldl_solve(Lf, Df, v, sol);
        for (int a1 = 0; a1 < QMPC_NU; ++a1)
          Ks[kb + QMPC_NX * a1 + j] = -sol[a1];
      }
      // Feed-forward k_t = -Luu^-1 (B^T p - rhs_t).
      float bp[QMPC_NU], lu[QMPC_NU], kv[QMPC_NU];
      mpc_btmv(pv, mk, Bw, bm, bp);
      for (int a1 = 0; a1 < QMPC_NU; ++a1) lu[a1] = bp[a1] - dF[t * QMPC_NU + a1];
      mpc_ldl_solve(Lf, Df, lu, kv);
      for (int a1 = 0; a1 < QMPC_NU; ++a1) kst[t * QMPC_NU + a1] = -kv[a1];
      // p <- A^T p + Lux^T k.
      float pA[QMPC_NX];
      mpc_atmv(pv, pA, cy, sy, dt, g_dt);
      for (int j = 0; j < QMPC_NX; ++j) {
        float acc = 0.0f;
        for (int a1 = 0; a1 < QMPC_NU; ++a1)
          acc = acc + Lux[QMPC_NX * a1 + j] * (-kv[a1]);
        pv[j] = pA[j] + acc;
      }
      // P <- Q + A^T P A + Lux^T K (PA holds the old P's products).
      for (int j = 0; j < QMPC_NX; ++j) {
        float col[QMPC_NX], at[QMPC_NX];
        for (int k = 0; k < QMPC_NX; ++k) col[k] = PA[QMPC_NX * k + j];
        mpc_atmv(col, at, cy, sy, dt, g_dt);
        for (int a = 0; a < QMPC_NX; ++a) {
          float acc = at[a];
          for (int u = 0; u < QMPC_NU; ++u)
            acc = acc + Lux[QMPC_NX * u + a] * Ks[kb + QMPC_NX * u + j];
          if (a == j) acc = acc + q_scale * p.w[j];
          P[QMPC_NX * a + j] = acc;
        }
      }
      for (int a = 0; a < QMPC_NX; ++a)
        for (int b = a + 1; b < QMPC_NX; ++b) {
          const float v = 0.5f * (P[QMPC_NX * a + b] + P[QMPC_NX * b + a]);
          P[QMPC_NX * a + b] = v;
          P[QMPC_NX * b + a] = v;
        }
    }

    // Forward rollout: dF_t = K_t dxi + k_t, dxi_0 = 0.
    {
      float dxi[QMPC_NX], x1[QMPC_NX], bu[QMPC_NX], du[QMPC_NU], mk[4];
      for (int k = 0; k < QMPC_NX; ++k) dxi[k] = 0.0f;
      for (int t = 0; t < N; ++t) {
        const int kb = t * QMPC_NU * QMPC_NX;
        for (int a1 = 0; a1 < QMPC_NU; ++a1) {
          float acc = kst[t * QMPC_NU + a1];
          for (int j = 0; j < QMPC_NX; ++j)
            acc = acc + Ks[kb + QMPC_NX * a1 + j] * dxi[j];
          du[a1] = acc;
          dF[t * QMPC_NU + a1] = acc;
        }
        masks(t, mk);
        mpc_amv(dxi, x1, cy, sy, dt, g_dt);
        mpc_bmv(du, mk, Bw, bm, bu);
        for (int k = 0; k < QMPC_NX; ++k) dxi[k] = x1[k] + bu[k];
      }
    }

    // Fraction to the boundary, the finite gate, the update.
    float amin = big;
    bool finite = true;
    for (int t = 0; t < N; ++t) {
      float u[QMPC_NU];
      for (int k = 0; k < QMPC_NU; ++k) {
        u[k] = dF[t * QMPC_NU + k];
        finite = finite && qfinite(u[k]);
      }
      for (int rr = 0; rr < QMPC_MC; ++rr) {
        const int q = t * QMPC_MC + rr;
        const float sv = ss[q], zv = zs[q];
        const float ds = -rp[q] - mpc_gx_row(u, rr, sf, gmu);
        const float dz = -((sv * zv - rc) + zv * ds) / sv;
        const float ra = ds < 0.0f ? -sv / ds : big;
        const float rb = dz < 0.0f ? -zv / dz : big;
        amin = qmin(amin, qmin(ra, rb));
      }
    }
    const float alpha_s = qmin(p.tau * amin, 1.0f);
    const float a = (done || frozen || !finite) ? 0.0f : alpha_s;
    if (a > 0.0f) {  // 0 * NaN = NaN: gate the update, never scale by 0
      for (int t = 0; t < N; ++t) {
        float u[QMPC_NU];
        for (int k = 0; k < QMPC_NU; ++k) {
          u[k] = dF[t * QMPC_NU + k];
          Fs[t * QMPC_NU + k] = Fs[t * QMPC_NU + k] + a * u[k];
        }
        for (int rr = 0; rr < QMPC_MC; ++rr) {
          const int q = t * QMPC_MC + rr;
          const float sv = ss[q], zv = zs[q];
          const float ds = -rp[q] - mpc_gx_row(u, rr, sf, gmu);
          const float dz = -((sv * zv - rc) + zv * ds) / sv;
          ss[q] = qmax(sv + a * ds, tiny);
          zs[q] = qmax(zv + a * dz, tiny);
        }
      }
    }
    frozen = frozen || done;
    a_prev = a;
  }

  // ---- final pass: residuals at the final iterate, best-vs-final pick -------
  float pr, dr, gap;
  residuals(pr, dr, gap);
  gap = gap * inv_nmc;
  const float merit_f = pr / h_scale + dr / obj_scale + gap / obj_scale;
  const bool use_final = (merit_f <= best_merit) || !track_best;
  for (int k = 0; k < N * QMPC_NU; ++k) {
    // Swing forces are exactly 0 at the optimum but converge slowly along
    // their 1e-6-curvature directions: project them out.
    const int t = k / QMPC_NU, leg = (k - t * QMPC_NU) / 3;
    const float mk = blk[off_st + 4 * t + leg];
    io.F[(size_t)k * sB + i] = (use_final ? Fs[k] : bF[k]) * sf * mk;
  }
  if (io.warm_out) {
    // Next tick's warm carry: [s | z / nu | F] of the FINAL iterate (a
    // consistent primal-dual point; the best-merit F above is the control
    // output and is not recycled).
    const float inv_nu = 1.0f / nu;
    for (int k = 0; k < N * QMPC_MC; ++k) {
      io.warm_out[(size_t)k * sB + i] = ss[k];
      io.warm_out[(size_t)(N * QMPC_MC + k) * sB + i] = zs[k] * inv_nu;
    }
    for (int k = 0; k < N * QMPC_NU; ++k) {
      const int t = k / QMPC_NU, leg = (k - t * QMPC_NU) / 3;
      const float mk = blk[off_st + 4 * t + leg];
      io.warm_out[(size_t)(2 * N * QMPC_MC + k) * sB + i] = Fs[k] * sf * mk;
    }
  }
  const bool conv =
      (pr < p.tol * h_scale) && (dr < p.tol * obj_scale) && (gap < p.tol * obj_scale);
  io.diag[0 * sB + i] = conv ? 1.0f : 0.0f;
  io.diag[1 * sB + i] = pr;
  io.diag[2 * sB + i] = dr;
  io.diag[3 * sB + i] = gap;
  io.diag[4 * sB + i] = nu;
  io.diag[5 * sB + i] = 0.0f;
}

}  // namespace qmpc_serial
