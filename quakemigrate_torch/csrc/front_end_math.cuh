// The arithmetic the onset front ends share (csrc/front_end.cu, FE1 and
// FE2; csrc/front_end_v2.cu, FE1 v2 and FE2 v2): every operation through
// the _rn intrinsics, which nvcc never contracts into an FMA, in the plain
// versions' term order; the levels of the reference's blocked running
// sum (ops/rolling.py's blocked_cumsum); FE1's transforms and FE2's
// powers and moments.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

#define FE_BLOCK 16
#define FE_MAX_LEVELS 8

__device__ __forceinline__ float fe_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double fe_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float fe_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double fe_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fe_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double fe_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fe_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double fe_div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fe_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double fe_sqrt(double a) { return __dsqrt_rn(a); }

// torch.clamp(x, min=m): NaN stays NaN
template <typename T>
__device__ __forceinline__ T fe_clamp_min(T x, T m) {
  return x < m ? m : x;
}

// The levels of a row of t samples: level 0 holds the totals of its
// blocks of 16, level l+1 those of level l's blocks while level l has
// more than 16 values; off is each level's offset in a row's stretch.
struct FeLevels {
  int n[FE_MAX_LEVELS];
  int off[FE_MAX_LEVELS];
  int count;
  int stride;
};

__host__ __device__ inline FeLevels fe_levels(int t) {
  FeLevels lv;
  lv.n[0] = (t + FE_BLOCK - 1) / FE_BLOCK;
  lv.off[0] = 0;
  lv.count = 1;
  while (lv.n[lv.count - 1] > FE_BLOCK) {
    const int c = lv.count;
    lv.n[c] = (lv.n[c - 1] + FE_BLOCK - 1) / FE_BLOCK;
    lv.off[c] = lv.off[c - 1] + lv.n[c - 1];
    lv.count = c + 1;
  }
  lv.stride = lv.off[lv.count - 1] + lv.n[lv.count - 1];
  return lv;
}

// The transform of FE1's samples: the square, the magnitude, or the
// sample as it is (an envelope taken before the kernel).
enum { FE_SQUARE = 0, FE_ABS = 1, FE_IDENTITY = 2 };

template <typename T>
__device__ __forceinline__ T fe_transform(T v, int mode) {
  return mode == FE_SQUARE ? fe_mul(v, v)
                           : (mode == FE_ABS ? (T)fabs(v) : v);
}

// x, x^2, x^3, x^4 as JAX's integer power forms them
template <typename T>
__device__ __forceinline__ void fe_powers(T v, T* p) {
  const T v2 = fe_mul(v, v);
  p[0] = v;
  p[1] = v2;
  p[2] = fe_mul(v, v2);
  p[3] = fe_mul(v2, v2);
}

// The kurtosis of a window of n samples from its four power sums s
// (ops/kurtosis.py's _kurtosis_from_sums, term by term).
template <typename T>
__device__ __forceinline__ T fe_kurtosis_from_sums(const T* s, T n,
                                                   T sqrt_tiny) {
  const T mean = fe_div(s[0], n);
  const T mean2 = fe_mul(mean, mean);
  const T m2 = fe_sub(fe_div(s[1], n), mean2);
  const T m4 = fe_sub(
      fe_add(fe_sub(fe_div(s[3], n), fe_mul(fe_mul(T(4), mean),
                                             fe_div(s[2], n))),
             fe_mul(fe_mul(T(6), mean2), fe_div(s[1], n))),
      fe_mul(T(3), fe_mul(mean2, mean2)));
  const T power = fe_div(s[1], n);
  const T m2f = fe_clamp_min(m2, sqrt_tiny);
  const T raw = fe_sub(fe_div(m4, fe_mul(m2f, m2f)), T(3));
  return m2 > fe_mul(power, T(1e-12)) ? raw : T(0);
}

static inline double fe_bits_to_double(int lo, int hi) {
  const uint64_t bits = (uint64_t)(uint32_t)lo | ((uint64_t)(uint32_t)hi << 32);
  double v;
  memcpy(&v, &bits, sizeof v);
  return v;
}
