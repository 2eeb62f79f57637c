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
// summed dy outer, dx inner, from 0, with separately rounded multiply and
// add (__fmul_rn / __fadd_rn, no FMA contraction), the noise added last:
// bit for bit the plain PyTorch version's sum. The TPU kernels' column
// permutation matmuls and baked halo rows are layout work for the TPU's
// vector unit; here they are address maps applied while staging.
//
// Design. A block owns TI output rows x TJ output columns of one channel:
// batch-minor maps (CHWB, presplit, baked-halo presplit), TJ columns of a
// 32-wide batch slice, one warp a column and a lane a batch entry, so
// every staged pixel is one coalesced 128-byte run; NCHW, one image and
// TJ = 32 columns a warp, a lane a column. It walks the f*(TI-1) + K input
// rows its outputs read, f*(TJ-1) + K columns wide, through a ring of
// shared-memory row buffers, and each thread keeps an accumulator for
// each output still open in its column, at most ceil(K/f) (`ring::walk`,
// stencil_ring.cuh). This file's part is
// staging a row: the row and column maps (clamp, presplit phase and
// permuted column, baked-halo rows read unclamped) are applied there and
// nowhere else, bfloat16 is converted to float32, float32 rows are copied
// by cp.async (16 bytes a lane for a batch that is a multiple of 4 on a
// 16-byte aligned tensor, else 4), and NCHW rows are stored with their
// columns phase-split (column x at (x % f, x / f)), so lane j reading
// column f*j + dx hits consecutive words. The tap loop has no clamp, no
// divide and no global load. The x8 factory's shape (f = 8, K = 20) has
// its own instantiation with every bound known at compile time; other
// shapes run the same walk with run-time bounds and ring::kSlots
// accumulators, a block taking at most kSlots output rows where ceil(K/f)
// is larger. A span whose comp copy and ring rows do not fit a block's
// shared memory (batch-minor K > 184, NCHW K > 236 at f <= 4) runs the
// global-read instantiation instead (`degrade_direct_kernel`: a thread an
// output, comp and pixels read through the read-only cache, the same tap
// order), so every span is taken. The noise is added as an output is
// written.
//
// Bound on an H100 at the factory shape (B=128, C=5, 256x256, f=8, K=20):
// 167.8 MB of input plus 2 x 2.6 MB of noise and output, 0.0516 ms at
// 3.35 TB/s. 655,360 outputs x 400 taps, a separately rounded multiply and
// add each on the FP32 pipe, is 0.52 G lane operations over 132 SMs x 128
// lanes x 1.98 GHz: 0.0157 ms. The bytes bind. A block stages
// (f*(TI-1)+K) x (f*(TJ-1)+K) pixels for f*TI x f*TJ of its own: 1.63x at
// the batch-minor plan (TI = 8, TJ = 4), 1.24x at the NCHW one (TI = 8,
// TJ = 32); the neighbours' overlap is read from L2.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (see kmsr_tpu_torch/kernels/__init__.py); exported as a plain C ABI and
// called through ctypes on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "stencil_ring.cuh"

namespace {

using ring::kLanes;
using ring::kRing;

constexpr int kNCHW = 0;          // x [B, C, H, W], noise/out [B, C, H/f, W/f]
constexpr int kCHWB = 1;          // x [C, H, W, B], noise/out [C, H/f, W/f, B]
constexpr int kPresplit = 2;      // x [C, f, H/f, W, B] with columns permuted to
                                  // v = (x % f) * (W/f) + x / f; noise/out CHWB
constexpr int kPresplitHalo = 3;  // x [C, f, H/f + 2m, W, B]: as kPresplit with
                                  // m replicate rows baked at each end
constexpr int kSmemMax = 232448;

struct Tile {
  int C, H, W, B, f, K, half, m;
  int oh, ow, n_o;  // output rows, columns; ceil(K/f)
  int TI, TJ;       // outputs a block: TI rows x TJ columns (NCHW: 32 a warp)
  int cols;         // staged columns of a window row (NCHW: per column phase)
  int row;          // floats of a ring buffer
  int span;         // window columns, f*(TJ-1) + K
  int kk;           // floats of the block's comp copy, K rows padded to 4
};

// one window element: float32 through cp.async, bfloat16 converted here
__device__ __forceinline__ void stage(float* dst, const float* src, bool valid) {
  ring::cp_async4(dst, src, valid);
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// F, KC: the compile-time shape (8, 20), or 0, 0 for any other.
template <int LAYOUT, int F, int KC, typename T>
__global__ void __launch_bounds__(256)
degrade_stencil_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                       const float* __restrict__ noise, float* __restrict__ out,
                       Tile t, int vec) {
  constexpr int NS = KC ? (KC + F - 1) / (F ? F : 1) : ring::kSlots;
  extern __shared__ __align__(16) float smem[];
  float* kc = smem;                                           // comp[c], rows padded
  float* rbuf = smem + t.kk;                                  // kRing rows
  int* s_src = reinterpret_cast<int*>(rbuf + kRing * t.row);  // column map
  int* s_dst = s_src + t.span;                                // NCHW: phase-split slot

  const int f = F ? F : t.f, K = KC ? KC : t.K;
  const int H = t.H, W = t.W, B = t.B, oh = t.oh, ow = t.ow;
  const int lane = threadIdx.x, wy = threadIdx.y, nw = blockDim.y;
  const int tid = wy * kLanes + lane, nthreads = kLanes * nw;

  // flat block index: column tile fastest, then row tile, then image / slice
  const int n_ct = (ow + t.TJ - 1) / t.TJ, n_rt = (oh + t.TI - 1) / t.TI;
  const int jt = blockIdx.x % n_ct, it = (blockIdx.x / n_ct) % n_rt;
  const int z = blockIdx.x / n_ct / n_rt;
  int c, b0, jl;  // channel; image (NCHW) or first batch entry; thread's column
  if (LAYOUT == kNCHW) {
    c = z % t.C;
    b0 = z / t.C;
    jl = wy * kLanes + lane;
  } else {
    const int slices = (B + kLanes - 1) / kLanes;
    c = z / slices;
    b0 = (z % slices) * kLanes;
    jl = wy;
  }
  const int i0 = it * t.TI, j0 = jt * t.TJ;
  const int y_base = f * i0 - t.half, x_base = f * j0 - t.half;

  ring::stage_coefficients(kc, comp + (int64_t)c * K * K, K, tid, nthreads);
  for (int wc = tid; wc < t.span; wc += nthreads) {
    const int xc = min(max(x_base + wc, 0), W - 1);
    s_src[wc] = LAYOUT == kPresplit || LAYOUT == kPresplitHalo
                    ? (xc % f) * ow + xc / f  // presplit column of image column xc
                    : xc;
    if (LAYOUT == kNCHW) s_dst[wc] = (wc % f) * t.cols + wc / f;
  }
  __syncthreads();

  const T* plane;
  if (LAYOUT == kNCHW) {
    plane = x + ((int64_t)b0 * t.C + c) * H * W;
  } else {
    const int64_t prow = LAYOUT == kPresplitHalo ? (int64_t)f * (oh + 2 * t.m) : H;
    plane = x + (int64_t)c * prow * W * B + b0;
  }

  // window row q (input row y_base + q) into ring buffer `dst`
  auto load_row = [&](int q, float* dst) {
    const int y = y_base + q;
    int64_t roff;  // pixel offset of the row inside the (c, b) plane
    if (LAYOUT == kPresplitHalo) {  // baked rows: read unclamped
      const int p = ((y % f) + f) % f;
      roff = ((int64_t)p * (oh + 2 * t.m) + t.m + (y - p) / f) * W;
    } else {
      const int yc = min(max(y, 0), H - 1);
      roff = LAYOUT == kPresplit ? ((int64_t)(yc % f) * oh + yc / f) * W
                                 : (int64_t)yc * W;
    }
    if (LAYOUT == kNCHW) {
      const T* src = plane + roff;
      for (int wc = tid; wc < t.span; wc += nthreads)
        stage(dst + s_dst[wc], src + s_src[wc], true);
    } else if (vec) {  // float32, batch a multiple of 4: 16-byte runs of it
      const float* src = reinterpret_cast<const float*>(plane) + roff * B;
      const int part = tid % 8;
      const bool ok = b0 + part * 4 < B;
      for (int wc = tid / 8; wc < t.span; wc += nthreads / 8)
        ring::cp_async16(dst + wc * kLanes + part * 4,
                         src + (int64_t)s_src[wc] * B + (ok ? part * 4 : 0), ok);
    } else {  // lanes along the batch
      const T* src = plane + roff * B;
      const bool ok = b0 + lane < B;
      for (int wc = wy; wc < t.span; wc += nw)
        stage(dst + wc * kLanes + lane, src + (int64_t)s_src[wc] * B + (ok ? lane : 0), ok);
    }
  };

  const int j = j0 + jl;
  const int b = LAYOUT == kNCHW ? b0 : b0 + lane;
  const bool writer = j < ow && b < B;
  auto emit = [&](int r, float v) {
    if (!writer) return;
    const int64_t o = LAYOUT == kNCHW ? (((int64_t)b * t.C + c) * oh + i0 + r) * ow + j
                                      : (((int64_t)c * oh + i0 + r) * ow + j) * B + b;
    out[o] = noise ? __fadd_rn(v, noise[o]) : v;
  };
  const int base = LAYOUT == kNCHW ? jl : f * jl * kLanes + lane;
  ring::walk<LAYOUT == kNCHW, F, KC, NS>(rbuf, t.row, base, kc,
                                         ring::Geom{f, K, t.n_o, t.cols},
                                         min(t.TI, oh - i0), load_row, emit);
}

// one input pixel through the read-only cache, as float32
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The global-read instantiation, taken where no shared-memory plan fits (a
// span whose comp copy and ring rows exceed a block's shared memory, e.g.
// batch-minor K > 184): a thread sums one output straight from global
// memory, comp and pixels through the read-only cache, with the row and
// column maps of `load_row` applied per tap, in the walk's order (dy
// outer, dx inner, from 0, separately rounded): the same bits.
template <int LAYOUT, typename T>
__global__ void __launch_bounds__(256)
degrade_direct_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                      const float* __restrict__ noise, float* __restrict__ out,
                      Tile t, int64_t n) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int f = t.f, K = t.K, H = t.H, W = t.W, B = t.B, oh = t.oh, ow = t.ow;
  int64_t r = o;
  int c, i, j, b;
  if (LAYOUT == kNCHW) {  // out [B, C, oh, ow]
    j = r % ow; r /= ow;
    i = r % oh; r /= oh;
    c = r % t.C;
    b = r / t.C;
  } else {                // out [C, oh, ow, B]
    b = r % B; r /= B;
    j = r % ow; r /= ow;
    i = r % oh;
    c = r / oh;
  }
  const T* plane;
  if (LAYOUT == kNCHW) {
    plane = x + ((int64_t)b * t.C + c) * H * W;
  } else {
    const int64_t prow = LAYOUT == kPresplitHalo ? (int64_t)f * (oh + 2 * t.m) : H;
    plane = x + (int64_t)c * prow * W * B + b;
  }
  const float* kc = comp + (int64_t)c * K * K;
  float acc = 0.f;
  for (int dy = 0; dy < K; ++dy) {
    const int y = f * i + dy - t.half;
    int64_t roff;
    if (LAYOUT == kPresplitHalo) {  // baked rows: read unclamped
      const int p = ((y % f) + f) % f;
      roff = ((int64_t)p * (oh + 2 * t.m) + t.m + (y - p) / f) * W;
    } else {
      const int yc = min(max(y, 0), H - 1);
      roff = LAYOUT == kPresplit ? ((int64_t)(yc % f) * oh + yc / f) * W : (int64_t)yc * W;
    }
    for (int dx = 0; dx < K; ++dx) {
      const int xc = min(max(f * j + dx - t.half, 0), W - 1);
      const int64_t col = LAYOUT == kPresplit || LAYOUT == kPresplitHalo
                              ? (int64_t)(xc % f) * ow + xc / f
                              : xc;
      const float v = ld(LAYOUT == kNCHW ? plane + roff + col : plane + (roff + col) * B);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(kc + dy * K + dx), v));
    }
  }
  out[o] = noise ? __fadd_rn(acc, noise[o]) : acc;
}

template <int LAYOUT, typename T>
int launch_direct(const void* x, const float* comp, const float* noise, float* out,
                  const Tile& t, cudaStream_t stream) {
  const int64_t n = (int64_t)t.C * t.oh * t.ow * t.B;
  const int64_t blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return -1;
  degrade_direct_kernel<LAYOUT, T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), comp, noise, out, t, n);
  return (int)cudaGetLastError();
}

size_t smem_bytes(const Tile& t, int layout) {
  return 4 * ((size_t)t.kk + (size_t)kRing * t.row +
              (size_t)t.span * (layout == kNCHW ? 2 : 1));
}

// The tile plan (`kmsr_tpu_torch.kernels.stencil_tiles` chooses it) must
// give every tap its staged window row and column, keep its open outputs
// in the walk's slots, and fit.
bool plan_ok(Tile& t, int layout) {
  if (t.TI <= 0 || t.TJ <= 0 || (t.n_o > ring::kSlots && t.TI > ring::kSlots))
    return false;
  t.span = t.f * (t.TJ - 1) + t.K;
  t.kk = t.K * ((t.K + 3) / 4 * 4);
  if (layout == kNCHW) {
    if (t.TJ % kLanes || t.TJ > 8 * kLanes || t.cols < t.TJ - 1 + t.n_o ||
        t.row < t.f * t.cols || t.row % 4)
      return false;
  } else {
    if (t.TJ > 8 || t.cols < t.span || t.row < t.cols * kLanes || t.row % 4)
      return false;
  }
  return smem_bytes(t, layout) <= kSmemMax;
}

template <int LAYOUT, int F, int KC, typename T>
int launch(const void* x, const float* comp, const float* noise, float* out,
           const Tile& t, cudaStream_t stream) {
  const size_t smem = smem_bytes(t, LAYOUT);
  auto kern = degrade_stencil_kernel<LAYOUT, F, KC, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t z = LAYOUT == kNCHW ? (int64_t)t.B * t.C
                                    : (int64_t)t.C * ((t.B + kLanes - 1) / kLanes);
  const int64_t blocks = (int64_t)((t.ow + t.TJ - 1) / t.TJ) *
                         ((t.oh + t.TI - 1) / t.TI) * z;
  if (blocks > INT32_MAX) return -1;
  dim3 block(kLanes, LAYOUT == kNCHW ? t.TJ / kLanes : t.TJ);
  // batch-minor float32 rows move in 16-byte runs of the batch when it allows
  const int vec = LAYOUT != kNCHW && sizeof(T) == 4 && t.B % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kern<<<(unsigned)blocks, block, smem, stream>>>(static_cast<const T*>(x), comp,
                                                  noise, out, t, vec);
  return (int)cudaGetLastError();
}

template <int LAYOUT, typename T>
int by_shape(const void* x, const float* comp, const float* noise, float* out,
             const Tile& t, cudaStream_t s) {
  if (t.TI == 0) return launch_direct<LAYOUT, T>(x, comp, noise, out, t, s);
#if KMSR_RING_SPECIALIZE
  if (t.f == 8 && t.K == 20) return launch<LAYOUT, 8, 20, T>(x, comp, noise, out, t, s);
#endif
  return launch<LAYOUT, 0, 0, T>(x, comp, noise, out, t, s);
}

template <typename T>
int dispatch(int layout, const void* x, const float* comp, const float* noise,
             float* out, const Tile& t, cudaStream_t s) {
  switch (layout) {
    case kNCHW:
      return by_shape<kNCHW, T>(x, comp, noise, out, t, s);
    case kCHWB:
      return by_shape<kCHWB, T>(x, comp, noise, out, t, s);
    case kPresplit:
      return by_shape<kPresplit, T>(x, comp, noise, out, t, s);
    default:
      return by_shape<kPresplitHalo, T>(x, comp, noise, out, t, s);
  }
}

int floor_div(int a, int b) { return (a - ((a % b) + b) % b) / b; }

}  // namespace

extern "C" {

// Launch the stencil on `stream`. x_dtype: 0 float32, 1 bfloat16. layout:
// 0 NCHW, 1 CHWB, 2 presplit, 3 presplit with m baked halo rows (see the
// k* constants). (c, h, w, b) are the image dims, h and w
// multiples of f; comp is [c, k, k] float32; `half` is the tap offset;
// noise is NULL or float32 in the output's layout. (ti, tj, cols, row) is
// the tile plan: ti x tj outputs a block (NCHW: tj a multiple of 32),
// staged columns of a window row (NCHW: per column phase) and floats of a
// ring buffer; all four 0 select the global-read kernel. Returns 0, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take (including a halo depth m that a tap
// would reach past, and a plan that does not cover the taps or fit shared
// memory).
int kmsr_degrade_stencil(const void* x, int x_dtype, int layout,
                         const float* comp, const float* noise, float* out,
                         int c, int h, int w, int b, int f, int k, int half,
                         int m, int ti, int tj, int cols, int row, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0 || b <= 0 || f <= 0 || k < f ||
      h % f || w % f || layout < 0 || layout > 3 || x_dtype < 0 || x_dtype > 1) {
    return -1;
  }
  if (layout == kPresplitHalo &&
      (m < 0 || floor_div(-half, f) < -m || floor_div(k - 1 - half, f) > m)) {
    return -1;
  }
  Tile t{};
  t.C = c;
  t.H = h;
  t.W = w;
  t.B = b;
  t.f = f;
  t.K = k;
  t.half = half;
  t.m = layout == kPresplitHalo ? m : 0;
  t.oh = h / f;
  t.ow = w / f;
  t.n_o = (k + f - 1) / f;
  t.TI = ti;
  t.TJ = tj;
  t.cols = cols;
  t.row = row;
  // the all-zero plan: no shared-memory staging, the global-read kernel
  const bool direct = ti == 0 && tj == 0 && cols == 0 && row == 0;
  if (!direct && !plan_ok(t, layout)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? dispatch<float>(layout, x, comp, noise, out, t, s)
             : dispatch<__nv_bfloat16>(layout, x, comp, noise, out, t, s);
}

const char* kmsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
