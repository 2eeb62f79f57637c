// Fused degrade stencil for NVIDIA Hopper (sm_90a): blur + x`factor` box
// downsample + optional noise-pool injection, in one pass.
//
// Replaces the Pallas TPU kernels of kmsr_tpu/ops/degrade_pallas.py
//   _degrade_kernel_v3    / _degrade_noise_kernel_v3     (raw [C, H, W, B];
//                                                          here also [B, C, H, W])
//   _degrade_kernel_v3psn / _degrade_noise_kernel_v3psn  (halo-free presplit
//                                                          [C, f, H/f, W, B])
//   _degrade_kernel_v3ps  / _degrade_noise_kernel_v3ps   (presplit with m
//                                                          baked halo rows,
//                                                          [C, f, H/f+2m, W, B])
// (the wide-span v1/v2 kernels live in degrade_wide.cu). All of them compute
//   out[c,i,j,b] = sum_{dy<K} sum_{dx<K} comp[c,dy,dx]
//                  * x[c, clamp(f*i+dy-h, 0, H-1), clamp(f*j+dx-h, 0, W-1), b]
//                  (+ noise[c,i,j,b])
// with comp = compose_with_box(normalize_kernel(k), f) ([C, K, K], K = k+f-1),
// replicate padding as clamped indices, the tap offset h = (K-f)/2, taps
// summed dy outer, dx inner. Inputs are float32 or bfloat16 (stored),
// accumulation and output float32. The TPU kernels' column permutation
// matmuls and baked halo rows are layout work for the TPU's vector unit; a
// CUDA thread gathers its clamped taps in place.
//
// Design (first, simple version): one thread per output element; the
// composed kernels of all bands (C*K*K floats, 8 KB at C=5, K=20) are
// staged once per block in shared memory, where every thread of a warp
// reads the same tap (a broadcast). Taps accumulate with separately
// rounded multiply and add, so the result matches the plain PyTorch
// reference (`acc = acc + k * x`, tap by tap, in the same order) bit for
// bit on the same inputs; the noise is added last.
//
// Bound on an H100: bytes. At the factory shape (B=128, C=5, 256x256,
// f=8, K=20) one launch must move 167.8 MB of input plus 2 x 2.6 MB of
// noise and output (~0.05 ms at 3.35 TB/s) for 0.52 GFLOP (~0.008 ms at
// 67 TFLOP/s fp32). Each input element is read by up to ceil(K/f)^2 output
// threads; the neighbours that share it run in the same or nearby blocks,
// so the re-reads come from L1/L2 and HBM sees the input about once. Index
// arithmetic, not memory, is what this version spends most of its
// instructions on; tiling the input through shared memory, as
// degrade_wide.cu does, is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (see kmsr_tpu_torch/kernels/__init__.py); exported as a plain C ABI and
// called through ctypes on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNCHW = 0;          // x [B, C, H, W], noise/out [B, C, H/f, W/f]
constexpr int kCHWB = 1;          // x [C, H, W, B], noise/out [C, H/f, W/f, B]
constexpr int kPresplit = 2;      // x [C, f, H/f, W, B] with columns permuted to
                                  // v = (x % f) * (W/f) + x / f; noise/out CHWB
constexpr int kPresplitHalo = 3;  // x [C, f, H/f + 2m, W, B]: as kPresplit with
                                  // m replicate rows baked at each end

struct Args {
  int C, H, W, B, f, K, half, m;
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Offset of image row (f*blk + r) inside one (c, b) image; rows outside
// the image clamp to row 0 / H-1, except in kPresplitHalo, whose layout
// carries the clamped rows itself. For the presplit maps r is the phase
// (0 <= r < f) and blk may lie in [-m, n_blk + m).
template <int LAYOUT>
__device__ __forceinline__ int64_t row_offset(int blk, int r, int f,
                                              int n_blk, int w, int b, int m) {
  if (LAYOUT == kPresplitHalo) {
    return ((int64_t)r * (n_blk + 2 * m) + m + blk) * w * b;
  }
  if (LAYOUT == kPresplit) {
    // presplit row y lives at [phase y % f, block y / f]
    int p = r, q = blk;
    if (blk < 0) {
      p = 0;
      q = 0;
    } else if (blk >= n_blk) {
      p = f - 1;
      q = n_blk - 1;
    }
    return ((int64_t)p * n_blk + q) * w * b;
  }
  int y = f * blk + r;
  y = y < 0 ? 0 : (y >= f * n_blk ? f * n_blk - 1 : y);
  return LAYOUT == kNCHW ? (int64_t)y * w : (int64_t)y * w * b;
}

// Offset of image column (f*blk + r), clamped, inside one row.
template <int LAYOUT>
__device__ __forceinline__ int64_t col_offset(int blk, int r, int f,
                                              int n_blk, int b) {
  if (LAYOUT == kPresplit || LAYOUT == kPresplitHalo) {
    // presplit column x lives at v = (x % f) * n_blk + x / f
    int v = r * n_blk + blk;
    if (blk < 0) v = 0;
    else if (blk >= n_blk) v = f * n_blk - 1;
    return (int64_t)v * b;
  }
  int x = f * blk + r;
  x = x < 0 ? 0 : (x >= f * n_blk ? f * n_blk - 1 : x);
  return LAYOUT == kNCHW ? (int64_t)x : (int64_t)x * b;
}

template <int LAYOUT, bool NOISE, typename T>
__global__ void __launch_bounds__(kThreads)
degrade_stencil_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                       const float* __restrict__ noise,
                       float* __restrict__ out, Args a) {
  extern __shared__ float s_comp[];
  const int C = a.C, B = a.B, W = a.W, f = a.f, K = a.K;
  const int kk = K * K;
  for (int t = threadIdx.x; t < C * kk; t += blockDim.x) s_comp[t] = comp[t];
  __syncthreads();

  const int oh = a.H / f, ow = W / f;
  const int64_t n_out = (int64_t)C * oh * ow * B;
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;

  // decompose the flat output index in the output's own memory order
  int b, c, i, j;
  if (LAYOUT == kNCHW) {
    j = (int)(o % ow);
    int64_t r = o / ow;
    i = (int)(r % oh);
    r /= oh;
    c = (int)(r % C);
    b = (int)(r / C);
  } else {
    b = (int)(o % B);
    int64_t r = o / B;
    j = (int)(r % ow);
    r /= ow;
    i = (int)(r % oh);
    c = (int)(r / oh);
  }

  // base of image (c, b); the per-layout strides live in row/col_offset
  const T* plane;
  int bs;  // batch stride of a pixel step (1 for NCHW: batch is outermost)
  if (LAYOUT == kNCHW) {
    plane = x + ((int64_t)b * C + c) * a.H * W;
    bs = 1;
  } else {
    const int64_t rows = LAYOUT == kPresplitHalo ? (int64_t)f * (oh + 2 * a.m)
                                                 : (int64_t)a.H;
    plane = x + (int64_t)c * rows * W * B + b;
    bs = B;
  }
  const float* kc = s_comp + c * kk;
  const int half = a.half;

  float acc = 0.f;
  // tap d reads image coordinate f*i + d - half = f*(i + q) + r with
  // (q, r) = divmod(d - half, f) (floor division); walk it incrementally
  const int r0 = ((-half) % f + f) % f;
  const int q0 = (-half - r0) / f;
  int qy = q0, ry = r0;
  for (int dy = 0; dy < K; ++dy) {
    const T* row = plane + row_offset<LAYOUT>(i + qy, ry, f, oh, W, bs, a.m);
    int qx = q0, rx = r0;
    for (int dx = 0; dx < K; ++dx) {
      const float v = load_f32(row + col_offset<LAYOUT>(j + qx, rx, f, ow, bs));
      acc = __fadd_rn(acc, __fmul_rn(kc[dy * K + dx], v));
      if (++rx == f) {
        rx = 0;
        ++qx;
      }
    }
    if (++ry == f) {
      ry = 0;
      ++qy;
    }
  }
  if (NOISE) acc = __fadd_rn(acc, noise[o]);
  out[o] = acc;
}

template <int LAYOUT, typename T>
int launch(const void* x, const float* comp, const float* noise, float* out,
           const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.C * a.K * a.K * sizeof(float);
  auto kern = noise ? degrade_stencil_kernel<LAYOUT, true, T>
                    : degrade_stencil_kernel<LAYOUT, false, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n_out = (int64_t)a.C * (a.H / a.f) * (a.W / a.f) * a.B;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), comp, noise, out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int layout, const void* x, const float* comp, const float* noise,
             float* out, const Args& a, cudaStream_t s) {
  switch (layout) {
    case kNCHW:
      return launch<kNCHW, T>(x, comp, noise, out, a, s);
    case kCHWB:
      return launch<kCHWB, T>(x, comp, noise, out, a, s);
    case kPresplit:
      return launch<kPresplit, T>(x, comp, noise, out, a, s);
    default:
      return launch<kPresplitHalo, T>(x, comp, noise, out, a, s);
  }
}

int floor_div(int a, int b) { return (a - ((a % b) + b) % b) / b; }

}  // namespace

extern "C" {

// Launch the stencil on `stream`. x_dtype: 0 float32, 1 bfloat16. layout:
// 0 NCHW, 1 CHWB, 2 presplit, 3 presplit with m baked halo rows (see the
// k* constants). (c, h, w, b) are the image dims, h and w
// multiples of f; comp is [c, k, k] float32; `half` is the tap offset;
// noise is NULL or float32 in the output's layout. Returns 0, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take
// (including a halo depth m that a tap would reach past).
int kmsr_degrade_stencil(const void* x, int x_dtype, int layout,
                         const float* comp, const float* noise, float* out,
                         int c, int h, int w, int b, int f, int k, int half,
                         int m, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0 || b <= 0 || f <= 0 || k < f ||
      h % f || w % f || layout < 0 || layout > 3 || x_dtype < 0 || x_dtype > 1 ||
      (size_t)c * k * k * sizeof(float) > 227 * 1024) {
    return -1;
  }
  if (layout == kPresplitHalo &&
      (m < 0 || floor_div(-half, f) < -m || floor_div(k - 1 - half, f) > m)) {
    return -1;
  }
  const Args a{c, h, w, b, f, k, half, layout == kPresplitHalo ? m : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? dispatch<float>(layout, x, comp, noise, out, a, s)
             : dispatch<__nv_bfloat16>(layout, x, comp, noise, out, a, s);
}

const char* kmsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
