// Small 3-vector / 3x3 helpers for the commander-pre and substep kernels
// (qct_commander.cuh, qct_substep.cuh). Vectors are float[3], matrices are
// row-major float[9]. Sums run left to right, as in the plain PyTorch
// versions; an output must not alias an input unless a comment says so.
#pragma once

#include "qct_common.cuh"

QCT_DEV void v3_set(float* o, float x, float y, float z) {
  o[0] = x;
  o[1] = y;
  o[2] = z;
}
QCT_DEV void v3_copy(float* o, const float* a) {
  o[0] = a[0];
  o[1] = a[1];
  o[2] = a[2];
}
// o = a + b (o may alias a or b)
QCT_DEV void v3_add(float* o, const float* a, const float* b) {
  o[0] = a[0] + b[0];
  o[1] = a[1] + b[1];
  o[2] = a[2] + b[2];
}
// o = a - b (o may alias a or b)
QCT_DEV void v3_sub(float* o, const float* a, const float* b) {
  o[0] = a[0] - b[0];
  o[1] = a[1] - b[1];
  o[2] = a[2] - b[2];
}
// o = s * a (o may alias a)
QCT_DEV void v3_scale(float* o, float s, const float* a) {
  o[0] = s * a[0];
  o[1] = s * a[1];
  o[2] = s * a[2];
}
QCT_DEV void v3_cross(float* o, const float* a, const float* b) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
// o = M v
QCT_DEV void m3_mv(float* o, const float* M, const float* v) {
  for (int i = 0; i < 3; ++i)
    o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}
// o = M^T v
QCT_DEV void m3_mtv(float* o, const float* M, const float* v) {
  for (int i = 0; i < 3; ++i)
    o[i] = M[i] * v[0] + M[3 + i] * v[1] + M[6 + i] * v[2];
}
// O = A B
QCT_DEV void m3_mul(float* O, const float* A, const float* B) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}
// O = A^T B
QCT_DEV void m3_tmul(float* O, const float* A, const float* B) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[3 * i + j] =
          A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}
// O = skew(v)
QCT_DEV void m3_skew(float* O, const float* v) {
  O[0] = 0.0f;
  O[1] = -v[2];
  O[2] = v[1];
  O[3] = v[2];
  O[4] = 0.0f;
  O[5] = -v[0];
  O[6] = -v[1];
  O[7] = v[0];
  O[8] = 0.0f;
}
// Adjugate and determinant of a 3x3 (no division).
QCT_DEV void m3_adj(const float* M, float* adj, float& det) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5],
              g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h;
  const float B = f * g - d * i;
  const float C = d * h - e * g;
  det = a * A + b * B + c * C;
  adj[0] = A;
  adj[1] = c * h - b * i;
  adj[2] = b * f - c * e;
  adj[3] = B;
  adj[4] = a * i - c * g;
  adj[5] = c * d - a * f;
  adj[6] = C;
  adj[7] = b * g - a * h;
  adj[8] = a * e - b * d;
}
// torch.clamp(v, lo, hi): NaN passes through.
QCT_DEV float qclamp(float v, float lo, float hi) {
  return qmin(qmax(v, lo), hi);
}

// Leg forward kinematics and Jacobian (ops/kinematics.py) from the sines and
// cosines of the abad angle (s1, c1), the thigh angle (s2, c2) and the sum of
// thigh and knee angles (s23, c23). L1 signed; sl2 = -l2, sl3 = -l3; hip:
// base->hip offset. foot or J may be null.
QCT_DEV void leg_fk_jac(float s1, float c1, float s2, float c2, float s23,
                        float c23, float L1, float sl2, float sl3,
                        const float* hip, float* foot, float* J) {
  const float zl = sl2 * c2 + sl3 * c23;
  const float xl = sl2 * s2 + sl3 * s23;
  if (foot) {
    foot[0] = xl + hip[0];
    foot[1] = L1 * c1 - s1 * zl + hip[1];
    foot[2] = L1 * s1 + c1 * zl + hip[2];
  }
  if (J) {
    const float l3s23 = sl3 * s23;
    J[0] = 0.0f;
    J[1] = zl;
    J[2] = sl3 * c23;
    J[3] = -L1 * s1 - c1 * zl;
    J[4] = xl * s1;
    J[5] = l3s23 * s1;
    J[6] = L1 * c1 - s1 * zl;
    J[7] = -(xl * c1);
    J[8] = -(l3s23 * c1);
  }
}

// Rodrigues (rotation vector -> row-major 3x3) with
// math/rotations.so3_exp's branch semantics: Taylor series below 1e-8.
QCT_DEV void so3_exp_f(const float* aa, float* R) {
  const float t2 = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  const float theta = sqrtf(t2);
  const bool taylor = theta < 1e-8f;
  const float safe_t2 = taylor ? 1.0f : t2;
  const float a = taylor ? 1.0f - t2 / 6.0f : sinf(theta) / sqrtf(safe_t2);
  const float b =
      taylor ? 0.5f - t2 / 24.0f : (1.0f - cosf(theta)) / safe_t2;
  float K[9];
  m3_skew(K, aa);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float k2 = 0.0f;
      for (int m = 0; m < 3; ++m) k2 = k2 + K[3 * i + m] * K[3 * m + j];
      float v = a * K[3 * i + j] + b * k2;
      if (i == j) v = v + 1.0f;
      R[3 * i + j] = v;
    }
}
