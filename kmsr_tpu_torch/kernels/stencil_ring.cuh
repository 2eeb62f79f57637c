// The row-ring walk shared by degrade_stencil.cu (the v3 family) and
// scene_stencil.cu (the scene slab stencil), for NVIDIA Hopper (sm_90a).
//
// A block's outputs i0 .. i0+tiv-1 of one column per thread read the input
// rows f*i0 - h + q, q < f*(tiv-1) + K, in increasing order. `walk` streams
// them through kRing row buffers in shared memory (the caller's `load_row`
// stages row q, applying its layout's maps, by cp.async or plain stores;
// three rows stay in flight), and each thread keeps one accumulator per
// output still open in its column: row q = f*g + t (group g, phase t)
// feeds output r at tap row dy = q - f*r for every r with 0 <= dy < K, at
// most ceil(K/f) of them. The row's window values are read into registers
// once and feed every open output; taps run dx = 0..K-1 with separately
// rounded multiply and add (__fmul_rn / __fadd_rn, no FMA contraction),
// from 0, so every output is the plain version's dy-outer, dx-inner sum
// bit for bit. Output r is complete at the end of group r + ceil(K/f) - 1:
// `emit(r, value)` gets it and the accumulators shift down one.

#pragma once

#include <cuda_runtime.h>

// 1: the f = 8, K = 20 shape (the x8 factory's and the scene path's) runs
// its compile-time instantiation; 0: the run-time one, as every other
// shape does (scripts/torch_stencil_sweep.py builds both to compare them).
#ifndef KMSR_RING_SPECIALIZE
#define KMSR_RING_SPECIALIZE 1
#endif

namespace ring {

constexpr int kLanes = 32;
constexpr int kRing = 4;   // row buffers: three rows in flight
constexpr int kSlots = 8;  // accumulators a thread keeps at run-time shapes

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The walk's run-time geometry: stride f, span K, ceil(K/f), and the
// staged columns per column phase of a phase-split row.
struct Geom {
  int f, K, n_o, cols;
};

// Add one window row (phase tt of its group) to the open outputs it
// feeds: slot v holds the block's output lo + v, fed at tap row
// dy = tt + f*(u0 - v), for v <= vlast. `s` points at the thread's tap
// dx = 0; tap dx lies at s[dx * 32] in a batch-minor row (SPLIT false: 32
// batch entries a column) and at s[(dx % f) * cols + dx / f] in a
// phase-split one. kc holds the K x K coefficients, each row padded with
// zeros to a multiple of 4 (`stage_coefficients`), read as float4s.
// F, KC: the compile-time shape, its K window values loaded into
// registers first and each slot's guard taken once a row; or 0, 0
// (run-time bounds): taps in chunks of 4, the values past K read as 0 (a
// padded term adds +0 * 0: the sum, which starts at +0 and so is never
// -0, is unchanged). One body for both measured 2 % slower at f=8, K=20
// (PERF.md).
template <bool SPLIT, int F, int KC, int NS>
__device__ __forceinline__ void add_row(const float* __restrict__ s,
                                        const float* __restrict__ kc,
                                        const Geom& gm, int tt, int u0, int vlast,
                                        float (&acc)[NS]) {
  const float4* kc4 = reinterpret_cast<const float4*>(kc);
  if constexpr (KC != 0) {
    static_assert(KC % 4 == 0, "a compile-time span's rows need no padding");
    float v[KC];
#pragma unroll
    for (int dx = 0; dx < KC; ++dx)
      v[dx] = SPLIT ? s[(dx % F) * gm.cols + dx / F] : s[dx * kLanes];
#pragma unroll
    for (int o = 0; o < NS; ++o) {
      const int dy = tt + F * (u0 - o);
      if (o <= vlast && dy < KC) {
#pragma unroll
        for (int d = 0; d < KC / 4; ++d) {
          const float4 w = kc4[dy * (KC / 4) + d];
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.x, v[4 * d]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.y, v[4 * d + 1]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.z, v[4 * d + 2]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.w, v[4 * d + 3]));
        }
      }
    }
  } else {
    const int f = gm.f, K = gm.K, kq = (K + 3) / 4;
    int px = 0, qx = 0;  // phase-split: column phase and step of the next tap
    for (int d = 0; d < kq; ++d) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 4 * d + e < K ? s[SPLIT ? px * gm.cols + qx : (4 * d + e) * kLanes] : 0.f;
        if (SPLIT && ++px == f) {
          px = 0;
          ++qx;
        }
      }
#pragma unroll
      for (int o = 0; o < NS; ++o) {
        const int dy = tt + f * (u0 - o);
        if (o <= vlast && dy < K) {
          const float4 w = kc4[dy * kq + d];
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.x, v[0]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.y, v[1]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.z, v[2]));
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w.w, v[3]));
        }
      }
    }
  }
}

// comp[c] (K x K, global) into kc with rows padded to a multiple of 4, by
// the block's nthreads threads from thread tid
__device__ __forceinline__ void stage_coefficients(float* kc, const float* comp,
                                                   int K, int tid, int nthreads) {
  const int kp = (K + 3) / 4 * 4;
  for (int e = tid; e < K * kp; e += nthreads) {
    const int dy = e / kp, dx = e % kp;
    kc[e] = dx < K ? comp[dy * K + dx] : 0.f;
  }
}

// Walk the block's rows: `ring` holds kRing buffers of `row` floats, `base`
// is the thread's offset in a buffer, kc the block's coefficients
// (`stage_coefficients`);
// load_row(q, dst) stages window row q into dst, emit(r, value) receives
// output i0 + r. NS slots hold min(ceil(K/f), tiv) open outputs (the plan
// keeps tiv <= NS where ceil(K/f) is larger). Every thread of the block
// calls it (it holds barriers).
template <bool SPLIT, int F, int KC, int NS, class LoadRow, class Emit>
__device__ __forceinline__ void walk(float* ring, int row, int base,
                                     const float* __restrict__ kc, const Geom& gm,
                                     int tiv, LoadRow load_row, Emit emit) {
  const int f = F ? F : gm.f, K = KC ? KC : gm.K;
  const int n_o = KC ? (KC + F - 1) / (F ? F : 1) : gm.n_o;
  const int rows = f * (tiv - 1) + K;  // input rows the block's outputs read
  float acc[NS];
#pragma unroll
  for (int o = 0; o < NS; ++o) acc[o] = 0.f;
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < rows) load_row(q, ring + q * row);
    cp_async_commit();
  }
  int g = 0, tt = 0, lo = 0;  // window row q = f*g + tt; oldest open output lo
  for (int q = 0; q < rows; ++q) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // row q is in; row q-1's buffer is free
    const int qn = q + kRing - 1;
    if (qn < rows) load_row(qn, ring + (qn % kRing) * row);
    cp_async_commit();
    add_row<SPLIT, F, KC, NS>(ring + (q % kRing) * row + base, kc, gm, tt, g - lo,
                              min(g, tiv - 1) - lo, acc);
    if (++tt == f || q == rows - 1) {  // group g ends
      if (g >= n_o - 1) {              // output lo = g - n_o + 1 is complete
        emit(lo, acc[0]);
#pragma unroll
        for (int o = 0; o < NS - 1; ++o) acc[o] = acc[o + 1];
        acc[NS - 1] = 0.f;
        ++lo;
      }
      tt = 0;
      ++g;
    }
  }
  cp_async_wait<0>();
}

}  // namespace ring
