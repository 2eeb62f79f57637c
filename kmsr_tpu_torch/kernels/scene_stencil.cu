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
// scene) is read in place. All offsets are int64 (5 x 8192^2 = 3.4e8).
//
// Design (first, simple version): one thread per output element, like the
// factory's degrade_stencil.cu; the composed kernels (C*K*K floats, 8 KB
// at C=5, K=20) are staged once per block in shared memory, where every
// thread of a warp reads the same tap (a broadcast). Taps accumulate in the
// plain PyTorch version's order (dy outer, dx inner) with separately
// rounded multiply and add, so the two agree bit for bit. The TPU path's
// column phase split pre-pass (`col_split`: Mosaic has no strided lane
// slice), its sublane tile pickers and its strip convs for the edge rows
// and border columns have no counterpart: a thread gathers its strided,
// clamped columns directly and the row map gives the halo rows.
//
// Bound on an H100: bytes. At the full scene width (C=5, 8192x8192 f32,
// f=8, K=20) one launch must read 1342 MB and write 21 MB (~0.41 ms at
// 3.35 TB/s) for 4.2 GFLOP (~0.06 ms at 67 TFLOP/s fp32). Neighbouring
// threads read columns f apart, so each 32-byte sector a warp touches
// serves f consecutive dx taps through L1, and each input row is read by
// ceil(K/f) output rows through L2. Index arithmetic and the L1 traffic of
// the strided gathers, not HBM, are what this version spends its time on;
// tiling rows through shared memory (TMA) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (see kmsr_tpu_torch/kernels/__init__.py); exported as a plain C ABI and
// called through ctypes on PyTorch's current stream.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Rows {
  const float* ptr;
  int64_t channel_stride;
  int64_t row_stride;
};

template <bool RAW>
__global__ void __launch_bounds__(kThreads)
scene_stencil_kernel(Rows x, Rows top, Rows bot, const float* __restrict__ comp,
                     float* __restrict__ out, int C, int hs, int W, int th,
                     int row0, int f, int K) {
  extern __shared__ float s_comp[];
  const int kk = K * K;
  for (int t = threadIdx.x; t < C * kk; t += blockDim.x) s_comp[t] = comp[t];
  __syncthreads();

  const int oh = hs / f, ow = W / f;
  const int64_t n_out = (int64_t)C * oh * ow;
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int j = (int)(o % ow);
  const int64_t r = o / ow;
  const int i = (int)(r % oh);
  const int c = (int)(r / oh);

  const int half = (K - f) / 2;
  const int y0 = f * i - half;  // slab row of tap dy = 0
  const int x0 = f * j - half;  // column of tap dx = 0, before the clamp
  const float* xc = x.ptr + (int64_t)c * x.channel_stride;
  const float* kc = s_comp + c * kk;

  float acc = 0.f;
  for (int dy = 0; dy < K; ++dy) {
    const int y = y0 + dy;
    const float* row;
    if (RAW) {
      if (y < 0) {
        row = top.ptr + (int64_t)c * top.channel_stride +
              (int64_t)(th + y) * top.row_stride;
      } else if (y >= hs) {
        row = bot.ptr + (int64_t)c * bot.channel_stride +
              (int64_t)(y - hs) * bot.row_stride;
      } else {
        row = xc + (int64_t)y * x.row_stride;
      }
    } else {
      row = xc + (int64_t)(row0 + y) * x.row_stride;
    }
    const float* k_row = kc + dy * K;
    for (int dx = 0; dx < K; ++dx) {
      int col = x0 + dx;
      col = col < 0 ? 0 : (col >= W ? W - 1 : col);
      acc = __fadd_rn(acc, __fmul_rn(k_row[dx], __ldg(row + col)));
    }
  }
  out[o] = acc;
}

template <bool RAW>
int launch(Rows x, Rows top, Rows bot, const float* comp, float* out, int c,
           int hs, int w, int th, int row0, int f, int k, cudaStream_t stream) {
  const size_t smem = (size_t)c * k * k * sizeof(float);
  auto kern = scene_stencil_kernel<RAW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n_out = (int64_t)c * (hs / f) * (w / f);
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(x, top, bot, comp, out,
                                                     c, hs, w, th, row0, f, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the scene stencil on `stream`. raw: 1 for the RAW row map (x is
// the [c, hs, w] slab, top/bot its [c, th, w] / [c, bh, w] halos), 0 for
// the EXT map (x is the [c, x_rows, w] extended slab, row y at x_rows
// index row0 + y; top/bot unused). *_cs / *_rs are channel / row strides
// in elements (column stride 1); comp is [c, k, k] float32 contiguous, out
// [c, hs/f, w/f] float32 contiguous. Returns 0, a cudaError_t code from
// the launch, or -1 for arguments the kernel does not take (dims not
// multiples of f, or halos that do not cover the taps' reach).
int kmsr_scene_stencil(int raw, const float* x, int64_t x_cs, int64_t x_rs,
                       int x_rows, const float* top, int64_t top_cs,
                       int64_t top_rs, int th, const float* bot,
                       int64_t bot_cs, int64_t bot_rs, int bh,
                       const float* comp, float* out, int c, int hs, int w,
                       int row0, int f, int k, void* stream) {
  const int half = (k - f) / 2;
  const int reach = k - half - f;  // rows read past the slab's last row
  if (c <= 0 || hs <= 0 || w <= 0 || f <= 0 || k < f || hs % f || w % f ||
      (int64_t)c * (hs / f) * (w / f) > (int64_t)INT32_MAX * kThreads ||
      (size_t)c * k * k * sizeof(float) > 227 * 1024) {
    return -1;
  }
  if (raw ? (x_rows != hs || th < half || bh < reach)
          : (row0 < half || row0 + hs + reach > x_rows)) {
    return -1;
  }
  Rows xr{x, x_cs, x_rs}, tr{top, top_cs, top_rs}, br{bot, bot_cs, bot_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return raw ? launch<true>(xr, tr, br, comp, out, c, hs, w, th, 0, f, k, s)
             : launch<false>(xr, tr, br, comp, out, c, hs, w, 0, row0, f, k, s);
}

const char* kmsr_scene_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
