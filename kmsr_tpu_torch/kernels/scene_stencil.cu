// Whole-scene degrade stencil for NVIDIA Hopper (sm_90a): blur + x`f` box
// downsample of one row slab of a scene, in one pass.
//
// Replaces the Pallas TPU kernels
//   kmsr_tpu/ops/degrade_scene_fast.py  _colsplit_raw_kernel   (RAW rows:
//       a halo-free slab plus thin top/bottom halos; behind degrade_rows_fast)
//   kmsr_tpu/ops/degrade_scene_fast.py  _colsplit_kernel       (EXT rows:
//       a halo-extended slab; behind degrade_slab_fast)
// Both compute, over the whole [C, Hs/f, W/f] output,
//   out[c,i,j] = sum_{dy<K} sum_{dx<K} comp[c,dy,dx]
//                * row(c, f*i+dy-h)[clamp(f*j+dx-h, 0, W-1)]
// with comp = compose_with_box(normalize_kernel(k), f) ([C, K, K]) and
// h = (K-f)/2. The two instantiations differ only in row(c, y):
//   RAW: y < 0 -> top[c, th+y]; y >= Hs -> bot[c, y-Hs]; else x[c, y]
//        (three separate tensors: no slab-sized concat is ever built);
//   EXT: x_ext[c, row0 + y] with row0 = TOP of the slab_halo contract.
// Every tensor is a row-major view with unit column stride; its channel
// and row strides are passed in, so a row slab of a scene (or a W-cropped
// scene, or a halo `expand`ed to row stride 0) is read in place. All
// offsets are int64 (5 x 8192^2 = 3.4e8). Taps accumulate in the plain
// PyTorch version's order (dy outer, dx inner, from 0) with separately
// rounded multiply and add (__fmul_rn / __fadd_rn), so the two agree bit
// for bit. The TPU path's column phase split pre-pass (`col_split`: Mosaic
// has no strided lane slice), its sublane tile pickers and its strip convs
// for the edge rows and border columns have no counterpart: the row map
// and the column clamp give the edges while a row is staged.
//
// Design: the walk of degrade_stencil.cu's NCHW map on a [C, rows, W]
// plane. A block owns TI output rows x TJ output columns of one channel, a
// lane one column; it walks the f*(TI-1) + K slab rows its outputs read,
// f*(TJ-1) + K columns wide, through a ring of shared-memory row buffers,
// and each thread keeps an accumulator for each output still open in its
// column, at most ceil(K/f) (`ring::walk`, stencil_ring.cuh). A row is staged by 4-byte cp.async (a
// cropped view's rows need not be 16-byte aligned, and a stride-0 halo is
// the same row again), the RAW/EXT row map and the column clamp applied
// while loading, through a per-block table of source columns, its columns
// phase-split (column x at (x % f, x / f)) so lane j reading column
// f*j + dx hits consecutive words. No clamp, divide or global load in the
// tap loop. f = 8, K = 20 (the scene path's x8 with a 13x13 blur) is a
// compile-time instantiation; other shapes run the same walk with
// run-time bounds and ring::kSlots accumulators, a block taking at most
// kSlots output rows where ceil(K/f) is larger. A span whose comp copy and
// ring rows do not fit a block's shared memory (K > 236 at f <= 4) runs
// the global-read instantiation instead (`scene_direct_kernel`: a thread an
// output, comp and rows read through the read-only cache, the same tap
// order), so every span is taken.
//
// Bound on an H100 at the full scene width (C=5, 8192x8192 f32, f=8,
// K=20): one launch must read 1342 MB and write 21 MB, 0.4075 ms at
// 3.35 TB/s; 5.24 M outputs x 400 taps x 2 lane operations on the FP32
// pipe (no FMA: bit equality) over 132 SMs x 128 lanes x 1.98 GHz is
// 0.125 ms. The bytes bind. A block (TI = 16, TJ = 128) stages
// 140 x 1036 pixels for 128 x 1024 of its own, 1.11x; the neighbours'
// overlap comes from L2.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (see kmsr_tpu_torch/kernels/__init__.py); exported as a plain C ABI and
// called through ctypes on PyTorch's current stream.

#include <cuda_runtime.h>

#include <stdint.h>

#include "stencil_ring.cuh"

namespace {

using ring::kLanes;
using ring::kRing;

constexpr int kSmemMax = 232448;

struct Rows {
  const float* ptr;
  int64_t channel_stride;
  int64_t row_stride;
};

struct Tile {
  int C, hs, W, th, row0, f, K, half;
  int oh, ow, n_o;  // output rows, columns; ceil(K/f)
  int TI, TJ;       // outputs a block: TI rows x TJ columns (32 a warp)
  int cols;         // staged columns of a window row, per column phase
  int row;          // floats of a ring buffer
  int span;         // window columns, f*(TJ-1) + K
  int kk;           // floats of the block's comp copy, K rows padded to 4
};

// F, KC: the compile-time shape (8, 20), or 0, 0 for any other.
template <bool RAW, int F, int KC>
__global__ void __launch_bounds__(256)
scene_stencil_kernel(Rows x, Rows top, Rows bot, const float* __restrict__ comp,
                     float* __restrict__ out, Tile t) {
  constexpr int NS = KC ? (KC + F - 1) / (F ? F : 1) : ring::kSlots;
  extern __shared__ __align__(16) float smem[];
  float* kc = smem;                                           // comp[c], rows padded
  float* rbuf = smem + t.kk;                                  // kRing rows
  int* s_src = reinterpret_cast<int*>(rbuf + kRing * t.row);  // clamped column
  int* s_dst = s_src + t.span;                                // phase-split slot

  const int f = F ? F : t.f, K = KC ? KC : t.K;
  const int W = t.W, hs = t.hs, oh = t.oh, ow = t.ow;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int tid = wy * kLanes + lane, nthreads = kLanes * blockDim.y;

  // flat block index: column tile fastest, then row tile, then channel
  const int n_ct = (ow + t.TJ - 1) / t.TJ, n_rt = (oh + t.TI - 1) / t.TI;
  const int jt = blockIdx.x % n_ct, it = (blockIdx.x / n_ct) % n_rt;
  const int c = blockIdx.x / n_ct / n_rt;
  const int jl = wy * kLanes + lane;
  const int i0 = it * t.TI, j0 = jt * t.TJ;
  const int y_base = f * i0 - t.half, x_base = f * j0 - t.half;

  ring::stage_coefficients(kc, comp + (int64_t)c * K * K, K, tid, nthreads);
  for (int wc = tid; wc < t.span; wc += nthreads) {
    s_src[wc] = min(max(x_base + wc, 0), W - 1);
    s_dst[wc] = (wc % f) * t.cols + wc / f;
  }
  __syncthreads();

  const float* xc = x.ptr + (int64_t)c * x.channel_stride;
  // window row q (slab row y_base + q) into ring buffer `dst`
  auto load_row = [&](int q, float* dst) {
    const int y = y_base + q;
    const float* src;
    if (RAW) {
      if (y < 0) {
        src = top.ptr + (int64_t)c * top.channel_stride + (int64_t)(t.th + y) * top.row_stride;
      } else if (y >= hs) {
        src = bot.ptr + (int64_t)c * bot.channel_stride + (int64_t)(y - hs) * bot.row_stride;
      } else {
        src = xc + (int64_t)y * x.row_stride;
      }
    } else {
      src = xc + (int64_t)(t.row0 + y) * x.row_stride;
    }
    for (int wc = tid; wc < t.span; wc += nthreads)
      ring::cp_async4(dst + s_dst[wc], src + s_src[wc], true);
  };

  const int j = j0 + jl;
  auto emit = [&](int r, float v) {
    if (j < ow) out[((int64_t)c * oh + i0 + r) * ow + j] = v;
  };
  ring::walk<true, F, KC, NS>(rbuf, t.row, jl, kc, ring::Geom{f, K, t.n_o, t.cols},
                              min(t.TI, oh - i0), load_row, emit);
}

// The global-read instantiation, taken where no shared-memory plan fits:
// a thread sums one output straight from global memory, comp and rows
// through the read-only cache, with `load_row`'s row map and the column
// clamp applied per tap, in the walk's order: the same bits.
template <bool RAW>
__global__ void __launch_bounds__(256)
scene_direct_kernel(Rows x, Rows top, Rows bot, const float* __restrict__ comp,
                    float* __restrict__ out, Tile t, int64_t n) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int f = t.f, K = t.K, W = t.W, hs = t.hs;
  const int j = o % t.ow, i = (o / t.ow) % t.oh, c = o / t.ow / t.oh;
  const float* kc = comp + (int64_t)c * K * K;
  float acc = 0.f;
  for (int dy = 0; dy < K; ++dy) {
    const int y = f * i + dy - t.half;
    const float* src;
    if (RAW) {
      if (y < 0) {
        src = top.ptr + (int64_t)c * top.channel_stride + (int64_t)(t.th + y) * top.row_stride;
      } else if (y >= hs) {
        src = bot.ptr + (int64_t)c * bot.channel_stride + (int64_t)(y - hs) * bot.row_stride;
      } else {
        src = x.ptr + (int64_t)c * x.channel_stride + (int64_t)y * x.row_stride;
      }
    } else {
      src = x.ptr + (int64_t)c * x.channel_stride + (int64_t)(t.row0 + y) * x.row_stride;
    }
    for (int dx = 0; dx < K; ++dx) {
      const int xc = min(max(f * j + dx - t.half, 0), W - 1);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(kc + dy * K + dx), __ldg(src + xc)));
    }
  }
  out[o] = acc;
}

template <bool RAW>
int launch_direct(Rows x, Rows top, Rows bot, const float* comp, float* out,
                  const Tile& t, cudaStream_t stream) {
  const int64_t n = (int64_t)t.C * t.oh * t.ow;
  const int64_t blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return -1;
  scene_direct_kernel<RAW><<<(unsigned)blocks, 256, 0, stream>>>(x, top, bot, comp, out, t, n);
  return (int)cudaGetLastError();
}

size_t smem_bytes(const Tile& t) {
  return 4 * ((size_t)t.kk + (size_t)kRing * t.row + 2 * (size_t)t.span);
}

// The tile plan (`kmsr_tpu_torch.kernels.scene_tiles` chooses it) must
// give every tap its staged window column, keep its open outputs in the
// walk's slots, and fit.
bool plan_ok(Tile& t) {
  if (t.TI <= 0 || t.TJ <= 0 || t.TJ % kLanes || t.TJ > 8 * kLanes ||
      (t.n_o > ring::kSlots && t.TI > ring::kSlots))
    return false;
  t.span = t.f * (t.TJ - 1) + t.K;
  t.kk = t.K * ((t.K + 3) / 4 * 4);
  if (t.cols < t.TJ - 1 + t.n_o || t.row < t.f * t.cols || t.row % 4) return false;
  return smem_bytes(t) <= kSmemMax;
}

template <bool RAW, int F, int KC>
int launch(Rows x, Rows top, Rows bot, const float* comp, float* out,
           const Tile& t, cudaStream_t stream) {
  const size_t smem = smem_bytes(t);
  auto kern = scene_stencil_kernel<RAW, F, KC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)((t.ow + t.TJ - 1) / t.TJ) *
                         ((t.oh + t.TI - 1) / t.TI) * t.C;
  if (blocks > INT32_MAX) return -1;
  dim3 block(kLanes, t.TJ / kLanes);
  kern<<<(unsigned)blocks, block, smem, stream>>>(x, top, bot, comp, out, t);
  return (int)cudaGetLastError();
}

template <bool RAW>
int by_shape(Rows x, Rows top, Rows bot, const float* comp, float* out,
             const Tile& t, cudaStream_t s) {
  if (t.TI == 0) return launch_direct<RAW>(x, top, bot, comp, out, t, s);
#if KMSR_RING_SPECIALIZE
  if (t.f == 8 && t.K == 20) return launch<RAW, 8, 20>(x, top, bot, comp, out, t, s);
#endif
  return launch<RAW, 0, 0>(x, top, bot, comp, out, t, s);
}

}  // namespace

extern "C" {

// Launch the scene stencil on `stream`. raw: 1 for the RAW row map (x is
// the [c, hs, w] slab, top/bot its [c, th, w] / [c, bh, w] halos), 0 for
// the EXT map (x is the [c, x_rows, w] extended slab, row y at x_rows
// index row0 + y; top/bot unused). *_cs / *_rs are channel / row strides
// in elements (column stride 1); comp is [c, k, k] float32 contiguous, out
// [c, hs/f, w/f] float32 contiguous. (ti, tj, cols, row) is the tile plan:
// ti x tj outputs a block (tj a multiple of 32), staged columns of a window
// row per column phase, floats of a ring buffer; all four 0 select the
// global-read kernel. Returns 0, a cudaError_t
// code from the launch, or -1 for arguments the kernel does not take (dims
// not multiples of f, halos that do not cover the taps' reach, a plan
// that does not cover the taps or fit shared memory).
int kmsr_scene_stencil(int raw, const float* x, int64_t x_cs, int64_t x_rs,
                       int x_rows, const float* top, int64_t top_cs,
                       int64_t top_rs, int th, const float* bot,
                       int64_t bot_cs, int64_t bot_rs, int bh,
                       const float* comp, float* out, int c, int hs, int w,
                       int row0, int f, int k, int ti, int tj, int cols,
                       int row, void* stream) {
  const int half = (k - f) / 2;
  const int reach = k - half - f;  // rows read past the slab's last row
  if (c <= 0 || hs <= 0 || w <= 0 || f <= 0 || k < f || hs % f || w % f) {
    return -1;
  }
  if (raw ? (x_rows != hs || th < half || bh < reach)
          : (row0 < half || row0 + hs + reach > x_rows)) {
    return -1;
  }
  Tile t{};
  t.C = c;
  t.hs = hs;
  t.W = w;
  t.th = th;
  t.row0 = raw ? 0 : row0;
  t.f = f;
  t.K = k;
  t.half = half;
  t.oh = hs / f;
  t.ow = w / f;
  t.n_o = (k + f - 1) / f;
  t.TI = ti;
  t.TJ = tj;
  t.cols = cols;
  t.row = row;
  // the all-zero plan: no shared-memory staging, the global-read kernel
  const bool direct = ti == 0 && tj == 0 && cols == 0 && row == 0;
  if (!direct && !plan_ok(t)) return -1;
  Rows xr{x, x_cs, x_rs}, tr{top, top_cs, top_rs}, br{bot, bot_cs, bot_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return raw ? by_shape<true>(xr, tr, br, comp, out, t, s)
             : by_shape<false>(xr, tr, br, comp, out, t, s);
}

const char* kmsr_scene_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
