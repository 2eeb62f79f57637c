// Dense stencil-matrix degrade for NVIDIA Hopper (sm_90a), on the tensor
// cores: the counterpart of the Pallas TPU kernel
//   kmsr_tpu/ops/degrade_pallas.py  _degrade_kernel_v4 / _degrade_noise_kernel_v4
// which folds the whole stride-f stencil (replicate padding included) into
// one dense [out_h*out_w, h*w] matrix A per channel and computes
//   out[c] ([out_hw, B]) = sum_{i+j<=2} A_i[c] . x_j[c]  (+ noise)
// with A = A_0 + A_1 + A_2 three bf16 terms split by mantissa masking (in
// the wrapper, as JAX does outside its kernel) and x split the same way
// here, in the kernel: x_0 = x & 0xFFFF0000, x_1 = (x - x_0) & 0xFFFF0000,
// x_2 = bf16_rn(x - x_0 - x_1). A bfloat16-stored x is its own single term
// (3 products instead of 6). Every bf16 x bf16 product is exact in float32.
//
// Design (first, simple version): one block of 4 warps computes a 32 x 32
// tile of out[c] (32 rows of A by 32 batch columns) with nvcuda::wmma
// bf16 16x16x16 fragments and float32 accumulators, one warp per 16 x 16
// sub-tile. Each of the (up to) six term products keeps its own
// accumulator over the whole contraction, and they are summed at the end
// in JAX's loop order (i outer, j inner), then the noise is added. Tiles of
// the three A terms and of the split x are staged through shared memory,
// 32 columns of the contraction at a time. Inside each mma the tensor core
// sums products in its own order, so the result is held to the degrade
// tolerance (rtol 1e-4 / atol 1e-5), not to bit equality.
//
// Layouts: x is read through (channel, pixel, batch) strides, so CHWB
// ([C, h, w, B]) and NCHW ([B, C, h, w]) both work in place; out and noise
// likewise. The batch needs no padding (ragged tiles are masked).
//
// Bound on an H100: the A terms are the bytes (39.8 MB at C=5, 48x48,
// f=2: 0.012 ms at 3.35 TB/s, with x and out 0.0145 ms) against 10.2 GFLOP
// of bf16 products (0.010 ms at 989 TFLOP/s): close to balanced. wmma
// through shared memory reaches a fraction of the tensor-core peak;
// TMA + wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int BM = 32, BN = 32, BK = 32;
constexpr int LDA = BK + 8;  // bf16 elements; rows stay 32-byte aligned
constexpr int LDX = BN + 8;
constexpr int LDC = BN + 4;  // float elements

__device__ __forceinline__ float mask_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides {
  int64_t xc, xp, xb;  // x: channel, pixel, batch
  int64_t oc, op, ob;  // out and noise
};

// XT: number of x terms (3 for float32 x, 1 for bfloat16-stored x)
template <typename T, int XT, bool NOISE>
__global__ void __launch_bounds__(kThreads)
degrade_dense_kernel(const T* __restrict__ x,
                     const __nv_bfloat16* __restrict__ a,
                     const float* __restrict__ noise, float* __restrict__ out,
                     int M, int KD, int N, Strides s) {
  __shared__ __align__(128) __nv_bfloat16 sA[3][BM][LDA];
  __shared__ __align__(128) __nv_bfloat16 sX[XT][BK][LDX];
  __shared__ __align__(128) float sC[BM][LDC];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const __nv_bfloat16* ac = a + (int64_t)c * 3 * M * KD;
  const T* xc = x + c * s.xc;
  const bool batch_fast = s.xb == 1;

  // d[i][j] accumulates A_i . x_j; only i + j <= 2 is used
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> d[3][XT];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < XT; ++j)
      if (i + j <= 2) wmma::fill_fragment(d[i][j], 0.f);

  for (int k0 = 0; k0 < KD; k0 += BK) {
    // A terms: 3 x BM x BK bf16 in 16-byte vectors (KD % 8 == 0)
    for (int v = tid; v < 3 * BM * BK / 8; v += kThreads) {
      const int t = v / (BM * BK / 8), rem = v % (BM * BK / 8);
      const int row = rem / (BK / 8), col = (rem % (BK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + col;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < KD) {
        val = *reinterpret_cast<const uint4*>(ac + ((int64_t)t * M + gm) * KD + gk);
      }
      *reinterpret_cast<uint4*>(&sA[t][row][col]) = val;
    }
    // x: BK x BN, split into its bf16 terms; neighbouring threads take
    // neighbouring addresses (batch-fast for CHWB, pixel-fast for NCHW)
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = batch_fast ? e / BN : e % BK;
      const int nn = batch_fast ? e % BN : e / BK;
      const int gk = k0 + kk, gn = n0 + nn;
      float v = 0.f;
      if (gk < KD && gn < N) v = to_f32(xc[gk * s.xp + gn * s.xb]);
      if constexpr (XT == 1) {
        sX[0][kk][nn] = __float2bfloat16_rn(v);  // exact: v came from bf16
      } else {
        const float t0 = mask_hi(v);
        const float r = __fsub_rn(v, t0);
        const float t1 = mask_hi(r);
        sX[0][kk][nn] = __float2bfloat16_rn(t0);
        sX[1][kk][nn] = __float2bfloat16_rn(t1);
        sX[2][kk][nn] = __float2bfloat16_rn(__fsub_rn(r, t1));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[3];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fx[XT];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        wmma::load_matrix_sync(fa[i], &sA[i][wm * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < XT; ++j)
        wmma::load_matrix_sync(fx[j], &sX[j][kk][wn * 16], LDX);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < XT; ++j)
          if (i + j <= 2) wmma::mma_sync(d[i][j], fa[i], fx[j], d[i][j]);
    }
    __syncthreads();
  }

  // sum the term products in JAX's order: i outer, j inner
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc = d[0][0];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < XT; ++j)
      if (i + j <= 2 && (i | j))
#pragma unroll
        for (int t = 0; t < acc.num_elements; ++t)
          acc.x[t] = __fadd_rn(acc.x[t], d[i][j].x[t]);
  wmma::store_matrix_sync(&sC[wm * 16][wn * 16], acc, LDC, wmma::mem_row_major);
  __syncthreads();

  const bool out_batch_fast = s.ob == 1;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int mm = out_batch_fast ? e / BN : e % BM;
    const int nn = out_batch_fast ? e % BN : e / BM;
    const int gm = m0 + mm, gn = n0 + nn;
    if (gm >= M || gn >= N) continue;
    const int64_t o = c * s.oc + gm * s.op + gn * s.ob;
    float v = sC[mm][nn];
    if (NOISE) v = __fadd_rn(v, noise[o]);
    out[o] = v;
  }
}

template <typename T, int XT>
int launch(const void* x, const __nv_bfloat16* a, const float* noise,
           float* out, int c, int m, int kd, int n, const Strides& s,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, c);
  auto kern = noise ? degrade_dense_kernel<T, XT, true>
                    : degrade_dense_kernel<T, XT, false>;
  kern<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), a, noise, out,
                                      m, kd, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the dense degrade on `stream`: out[c] = sum_{i+j<=2} A_i[c] x_j[c]
// (+ noise). x_dtype: 0 float32, 1 bfloat16. a: [c, 3, m, kd] bfloat16
// (the stencil matrix's three terms), contiguous, 16-byte aligned;
// m = out_h*out_w, kd = h*w (a multiple of 8), n = the batch. x is read at
// x[ch*x_cs + p*x_ps + b*x_bs] for pixel p < kd; out and noise (NULL or
// float32) at [ch*o_cs + q*o_ps + b*o_bs] for output pixel q < m. Returns
// 0, a cudaError_t code from the launch, or -1 for arguments the kernel
// does not take.
int kmsr_degrade_dense(const void* x, int x_dtype, const void* a,
                       const float* noise, float* out, int c, int m, int kd,
                       int n, int64_t x_cs, int64_t x_ps, int64_t x_bs,
                       int64_t o_cs, int64_t o_ps, int64_t o_bs, void* stream) {
  if (c <= 0 || m <= 0 || kd <= 0 || n <= 0 || kd % 8 || c > 65535 ||
      (m + BM - 1) / BM > 65535 || x_dtype < 0 || x_dtype > 1 ||
      reinterpret_cast<uintptr_t>(a) % 16) {
    return -1;
  }
  const Strides s{x_cs, x_ps, x_bs, o_cs, o_ps, o_bs};
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? launch<float, 3>(x, ab, noise, out, c, m, kd, n, s, st)
             : launch<__nv_bfloat16, 1>(x, ab, noise, out, c, m, kd, n, s, st);
}

const char* kmsr_dense_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
