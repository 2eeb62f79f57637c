// Wide-span fused degrade for NVIDIA Hopper (sm_90a): blur + x`factor`
// box downsample + optional noise, with the input tiled through shared
// memory. Replaces the Pallas TPU kernels of kmsr_tpu/ops/degrade_pallas.py
//   _degrade_kernel_v2 / _degrade_noise_kernel_v2   (V2: NCHW and CHWB)
//   _degrade_kernel    / _degrade_noise_kernel      (V1: per-row-phase
//                                                    partials; CHWB, the only
//                                                    layout that reaches it)
// Both compute
//   out[c,i,j,b] = sum_{dy<K} sum_{dx<K} comp[c,dy,dx]
//                  * x[c, clamp(f*i+dy-h, 0, H-1), clamp(f*j+dx-h, 0, W-1), b]
//                  (+ noise[c,i,j,b])
// with the tap offset h = k/2 (the blur kernel's own half width, a launch
// argument). Tap order, as in each TPU kernel: dyi, dxi, dxo, dyo over the
// ceil(K/f)*f lattice, dy = dyo*f + dyi, dx = dxo*f + dxi, skipping lattice
// taps with dy or dx >= K (V2); V1 sums each row phase dyi into its own
// partial and takes acc = acc + partial in dyi order. Every multiply and
// add is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction),
// so each output is bit-equal to the plain PyTorch version's.
//
// Design. A block owns a tile of outputs of one channel: NCHW, one image
// b and TI x 32 outputs (a warp spans 32 output columns); CHWB, TI x TJ
// outputs of a 32-wide batch slice (a warp spans the batch, so every load
// is coalesced). Since row phase dyi is the outermost loop of both tap
// orders, the block stages its input window one row phase at a time: the
// window rows f*q + dyi, replicate clamping applied while loading and
// nowhere else, converted to float32 (bfloat16 storage), float32 windows
// copied with cp.async (16 bytes at a time for a CHWB batch that allows
// it), the next phase's copy in flight while the current one is summed
// (two buffers). NCHW windows are stored with their columns phase-split
// (column x at (x % f, x / f)) so a warp's 32 columns read 32 consecutive
// words. Each thread then sums R = 8 outputs down one output column: for
// every lattice column it loads the R + ceil(K/f) - 1 window values that
// its outputs' row taps share into registers once, and feeds each to up
// to ceil(K/f) of its outputs, the column's coefficients read as float4s
// from a lattice-ordered copy of comp; no clamp, divide or global load in
// the tap loop. The x2 factory's lattice (f = 2, ceil(K/f) = 7) has its
// own instantiation with every loop bound and stride known at compile
// time, so the tap loop is only loads, multiplies and adds; other shapes
// run the same code with them read at run time. A span whose window does
// not fit shared memory at any tile runs the global-read instantiation
// (`degrade_wide_direct_kernel`: a thread an output, the same tap order).
//
// Bound on an H100 at B=128, C=5, 256x256, f=2, K=14: 167.8 MB of input,
// 2 x 41.9 MB of noise and output (0.0751 ms at 3.35 TB/s) against 2.06 G
// taps. Counted as fused multiply-adds that is 4.1 GFLOP (0.0615 ms at 67
// TFLOP/s fp32); bit equality forbids the fusion, so each tap is a multiply
// and an add on the FP32 pipe: 4.1 G lane operations over 132 SMs x 128
// lanes x 1.98 GHz, 0.123 ms. That instruction floor, not the bytes, is the
// limit this design aims at.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kNCHW = 0, kCHWB = 1;  // x [B, C, H, W] / [C, H, W, B]
constexpr int kV2 = 1, kV1 = 2;      // tap orders (the C ABI's mode codes)
constexpr int R = 8;                 // outputs a thread sums, down a column
constexpr int kLanes = 32;
constexpr int kTJ = 8;               // CHWB output columns a block, compile-time case
constexpr int kSmemMax = 232448;

struct Tile {
  int C, H, W, B, f, K, half, n_o;
  int oh, ow;
  int TI, TJ;     // output tile: rows, columns (NCHW: TJ = 32)
  int rows;       // window rows staged per phase
  int cols;       // window columns (NCHW: per column phase)
  int lw;         // coefficient-table row: row taps, padded to 4
  int table;      // floats of the coefficient table, padded to 4
  int phase;      // floats per phase buffer
};

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

// one window element: float32 through cp.async, bfloat16 converted here
__device__ __forceinline__ void stage(float* dst, const float* src, bool valid) {
  cp_async4(dst, src, valid);
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// Geometry known at compile time for the x2 lattice (F = 2, NO = 7), read
// from the tile plan otherwise (F = 0): row taps per register window, and
// the window columns and strides of each layout.
template <int LAYOUT, int F, int NO>
struct Geom {
  static constexpr int NOC = F ? NO : 4;
  static constexpr int NOP = (NOC + 3) / 4 * 4;  // coefficients read, float4s
  static constexpr int TJ = LAYOUT == kNCHW ? kLanes : kTJ;
  static constexpr int COLS = LAYOUT == kNCHW ? kLanes - 1 + NO : F * (kTJ - 1) + F * NO;
  __device__ static int cols(const Tile& t) { return F ? COLS : t.cols; }
  __device__ static int tj(const Tile& t) { return F ? TJ : t.TJ; }
};

// Add row phase dyi's taps to sum[R], in the lattice order. `s` points at
// the thread's first window row in the phase buffer; window row q of its
// strip is s[q * rs], lattice column (dxi, dxo) at offset
// dxi * cs_i + dxo * cs_o; ct holds comp in lattice order (see the kernel).
template <int F, int NO, int NOC, int NOP>
__device__ __forceinline__ void add_phase(const float* __restrict__ s, int rs,
                                          int cs_i, int cs_o,
                                          const float* __restrict__ ct,
                                          const Tile& t, int dyi, float (&sum)[R]) {
  const int f = F ? F : t.f, n_o = F ? NO : t.n_o;
#pragma unroll
  for (int dxi = 0; dxi < f; ++dxi) {
#pragma unroll
    for (int dxo = 0; dxo < n_o; ++dxo) {
      const int dx = dxo * f + dxi;
      if (dx >= t.K) break;
      const float* col = s + dxi * cs_i + dxo * cs_o;
      const float* w4 = ct + (dyi * t.K + dx) * t.lw;
#pragma unroll
      for (int dyo0 = 0; dyo0 < n_o; dyo0 += NOC) {
        float v[R + NOC - 1];
#pragma unroll
        for (int q = 0; q < R + NOC - 1; ++q) v[q] = col[(dyo0 + q) * rs];
        float w[NOP];
#pragma unroll
        for (int u = 0; u < NOP; u += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(w4 + dyo0 + u);
          w[u] = c4.x;
          w[u + 1] = c4.y;
          w[u + 2] = c4.z;
          w[u + 3] = c4.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int u = 0; u < NOC; ++u)
            if (dyo0 + u < n_o && (dyo0 + u) * f + dyi < t.K)
              sum[r] = __fadd_rn(sum[r], __fmul_rn(w[u], v[r + u]));
      }
    }
  }
}

template <int LAYOUT, int MODE, int F, int NO, typename T>
__global__ void __launch_bounds__(512)
degrade_wide_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                    const float* __restrict__ noise, float* __restrict__ out,
                    Tile t, int vec) {
  using G = Geom<LAYOUT, F, NO>;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                // comp in lattice order
  float* s_win = smem + t.table;   // two phase buffers

  const int f = F ? F : t.f, H = t.H, W = t.W, B = t.B, K = t.K;
  const int cols = G::cols(t), tj = G::tj(t);
  const int lane = threadIdx.x, wy = threadIdx.y, nwarps = blockDim.y;
  const int tid = wy * kLanes + lane, nthreads = kLanes * nwarps;
  int c, b0, grp, jl;
  if (LAYOUT == kNCHW) {  // blockIdx.z = b*C + c; lane = output column
    c = blockIdx.z % t.C;
    b0 = blockIdx.z / t.C;
    grp = wy;
    jl = lane;
  } else {  // blockIdx.z = c * batch slices + slice; lane = batch
    const int slices = (B + kLanes - 1) / kLanes;
    c = blockIdx.z / slices;
    b0 = (blockIdx.z % slices) * kLanes;
    grp = wy / tj;
    jl = wy % tj;
  }
  const int i0 = blockIdx.y * t.TI, j0 = blockIdx.x * tj;
  const int y_base = f * i0 - t.half, x_base = f * j0 - t.half;

  // ct[(dyi*K + dx)*lw + dyo] = comp[c, dyo*f + dyi, dx], 0 past the kernel
  for (int e = tid; e < f * K * t.lw; e += nthreads) {
    const int row = e / t.lw, dyo = e % t.lw, dyi = row / K, dx = row % K;
    const int dy = dyo * f + dyi;
    ct[e] = dyo < t.n_o && dy < K ? comp[(c * K + dy) * K + dx] : 0.f;
  }

  // phase dyi's window rows f*q + dyi, q < t.rows, into buffer `buf`
  auto load_phase = [&](int buf, int dyi) {
    float* dst = s_win + buf * t.phase;
    if (LAYOUT == kNCHW) {  // lanes along image columns; stored [q][x % f][x / f]
      const T* plane = x + ((int64_t)b0 * t.C + c) * H * W;
      for (int wc = lane; wc < f * cols; wc += kLanes) {
        const T* src = plane + min(max(x_base + wc, 0), W - 1);
        float* d = dst + (wc % f) * cols + wc / f;
        for (int q = wy; q < t.rows; q += nwarps) {
          const int y = min(max(y_base + f * q + dyi, 0), H - 1);
          stage(d + q * f * cols, src + (int64_t)y * W, true);
        }
      }
    } else if (vec) {  // float32, batch a multiple of 4: 16-byte runs of it
      const T* plane = x + (int64_t)c * H * W * B + b0;
      const int part = tid % 8, slot = tid / 8;
      for (int rc = slot; rc < t.rows * cols; rc += nthreads / 8) {
        const int q = rc / cols, wc = rc - q * cols;
        const int y = min(max(y_base + f * q + dyi, 0), H - 1);
        const int xx = min(max(x_base + wc, 0), W - 1);
        const bool ok = b0 + part * 4 < B;
        cp_async16(dst + rc * kLanes + part * 4,
                   reinterpret_cast<const float*>(plane) +
                       ((int64_t)y * W + xx) * B + (ok ? part * 4 : 0), ok);
      }
    } else {  // lanes along the batch; stored [q][wc][b]
      const T* plane = x + (int64_t)c * H * W * B + b0;
      const bool ok = b0 + lane < B;
      for (int rc = wy; rc < t.rows * cols; rc += nwarps) {
        const int q = rc / cols, wc = rc - q * cols;
        const int y = min(max(y_base + f * q + dyi, 0), H - 1);
        const int xx = min(max(x_base + wc, 0), W - 1);
        stage(dst + rc * kLanes + lane, plane + ((int64_t)y * W + xx) * B + (ok ? lane : 0), ok);
      }
    }
  };

  // the thread's strip: window rows from grp*R, and its lattice strides
  int rs, cs_i, cs_o, base;
  if (LAYOUT == kNCHW) {
    rs = f * cols;
    cs_i = cols;
    cs_o = 1;
    base = grp * R * rs + jl;
  } else {
    rs = cols * kLanes;
    cs_i = kLanes;
    cs_o = f * kLanes;
    base = grp * R * rs + f * jl * kLanes + lane;
  }

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  load_phase(0, 0);
  cp_async_commit();
  for (int dyi = 0; dyi < f; ++dyi) {
    if (dyi + 1 < f) {
      load_phase((dyi + 1) & 1, dyi + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s = s_win + (dyi & 1) * t.phase + base;
    if constexpr (MODE == kV1) {  // the phase's own partial, then acc + partial
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      add_phase<F, NO, G::NOC, G::NOP>(s, rs, cs_i, cs_o, ct, t, dyi, part);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
    } else {
      add_phase<F, NO, G::NOC, G::NOP>(s, rs, cs_i, cs_o, ct, t, dyi, acc);
    }
    __syncthreads();
  }

  const int j = j0 + jl;
  if (j >= t.ow) return;
  const int b = LAYOUT == kNCHW ? b0 : b0 + lane;
  if (b >= B) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + grp * R + r;
    if (i >= t.oh) break;
    const int64_t o = LAYOUT == kNCHW
                          ? (((int64_t)b * t.C + c) * t.oh + i) * t.ow + j
                          : (((int64_t)c * t.oh + i) * t.ow + j) * B + b;
    float v = acc[r];
    if (noise) v = __fadd_rn(v, noise[o]);
    out[o] = v;
  }
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The global-read instantiation, taken where no tile's window fits shared
// memory (the window grows as K^2/f: CHWB K > 32 at f = 2, NCHW K > 150):
// a thread sums one output straight from global memory, comp and pixels
// through the read-only cache, clamping per tap, in its version's lattice
// order (dyi, dxi, dxo, dyo; V1 a partial per dyi): the same bits.
template <int LAYOUT, int MODE, typename T>
__global__ void __launch_bounds__(256)
degrade_wide_direct_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                           const float* __restrict__ noise, float* __restrict__ out,
                           Tile t, int64_t n) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int f = t.f, K = t.K, H = t.H, W = t.W, B = t.B, n_o = t.n_o;
  int64_t r = o;
  int c, i, j, b;
  if (LAYOUT == kNCHW) {  // out [B, C, oh, ow]
    j = r % t.ow; r /= t.ow;
    i = r % t.oh; r /= t.oh;
    c = r % t.C;
    b = r / t.C;
  } else {                // out [C, oh, ow, B]
    b = r % B; r /= B;
    j = r % t.ow; r /= t.ow;
    i = r % t.oh;
    c = r / t.oh;
  }
  const T* plane = LAYOUT == kNCHW ? x + ((int64_t)b * t.C + c) * H * W
                                   : x + (int64_t)c * H * W * B + b;
  const int64_t xs = LAYOUT == kNCHW ? 1 : B;  // elements a pixel
  const float* kc = comp + (int64_t)c * K * K;
  float acc = 0.f;
  for (int dyi = 0; dyi < f; ++dyi) {
    float part = 0.f;
    float& sum = MODE == kV1 ? part : acc;
    for (int dxi = 0; dxi < f; ++dxi) {
      for (int dxo = 0; dxo < n_o; ++dxo) {
        const int dx = dxo * f + dxi;
        if (dx >= K) break;
        const int xc = min(max(f * j + dx - t.half, 0), W - 1);
        for (int dyo = 0; dyo < n_o; ++dyo) {
          const int dy = dyo * f + dyi;
          if (dy >= K) break;
          const int yc = min(max(f * i + dy - t.half, 0), H - 1);
          const float v = ld(plane + ((int64_t)yc * W + xc) * xs);
          sum = __fadd_rn(sum, __fmul_rn(__ldg(kc + dy * K + dx), v));
        }
      }
    }
    if (MODE == kV1) acc = __fadd_rn(acc, part);
  }
  out[o] = noise ? __fadd_rn(acc, noise[o]) : acc;
}

template <int LAYOUT, int MODE, typename T>
int launch_direct(const void* x, const float* comp, const float* noise, float* out,
                  const Tile& t, cudaStream_t stream) {
  const int64_t n = (int64_t)t.C * t.oh * t.ow * t.B;
  const int64_t blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return -1;
  degrade_wide_direct_kernel<LAYOUT, MODE, T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), comp, noise, out, t, n);
  return (int)cudaGetLastError();
}

// The tile plan (`kmsr_tpu_torch.kernels.wide_tiles` chooses it) must
// give every tap its staged window row and column, match the compile-time
// geometry where there is one, and fit.
template <int LAYOUT, int F, int NO>
bool plan_ok(Tile& t) {
  using G = Geom<LAYOUT, F, NO>;
  if (F && (t.f != F || t.n_o != NO || t.TJ != G::TJ || t.cols != G::COLS)) return false;
  const int n_chunk = (t.n_o + G::NOC - 1) / G::NOC * G::NOC;
  const int groups = t.TI / R;
  if (t.TI <= 0 || t.TI % R || t.TJ <= 0 || t.rows < t.TI - 1 + n_chunk) return false;
  if (LAYOUT == kNCHW) {
    if (t.TJ != kLanes || groups > 16 || t.cols < t.TJ - 1 + t.n_o) return false;
    t.phase = t.rows * t.f * t.cols;
  } else {
    if (groups * t.TJ > 16 || t.cols < t.f * (t.TJ - 1) + t.K) return false;
    t.phase = t.rows * t.cols * kLanes;
  }
  t.lw = (n_chunk + 3) / 4 * 4;
  t.table = (t.f * t.K * t.lw + 3) / 4 * 4;
  return 4LL * (t.table + 2LL * t.phase) <= kSmemMax;
}

template <int LAYOUT, int MODE, int F, int NO, typename T>
int launch(const void* x, const float* comp, const float* noise, float* out,
           Tile t, cudaStream_t stream) {
  if (!plan_ok<LAYOUT, F, NO>(t)) return -1;
  const size_t smem = 4 * ((size_t)t.table + 2 * (size_t)t.phase);
  auto kern = degrade_wide_kernel<LAYOUT, MODE, F, NO, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = t.TI / R;
  dim3 block(kLanes, LAYOUT == kNCHW ? groups : groups * t.TJ);
  const int z = LAYOUT == kNCHW ? t.B * t.C : t.C * ((t.B + kLanes - 1) / kLanes);
  dim3 grid((t.ow + t.TJ - 1) / t.TJ, (t.oh + t.TI - 1) / t.TI, z);
  // CHWB float32 windows move in 16-byte runs of the batch when it allows
  const int vec = LAYOUT == kCHWB && sizeof(T) == 4 && t.B % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kern<<<grid, block, smem, stream>>>(static_cast<const T*>(x), comp, noise, out, t, vec);
  return (int)cudaGetLastError();
}

// noc: the row taps one register window holds; 7 selects the x2 lattice's
// compile-time instantiation (f = 2, ceil(K/f) = 7), 4 the general one
template <int LAYOUT, int MODE, typename T>
int by_chunk(int noc, const void* x, const float* comp, const float* noise,
             float* out, const Tile& t, cudaStream_t s) {
  if (t.TI == 0) return launch_direct<LAYOUT, MODE, T>(x, comp, noise, out, t, s);
  return noc == 7 ? launch<LAYOUT, MODE, 2, 7, T>(x, comp, noise, out, t, s)
                  : launch<LAYOUT, MODE, 0, 0, T>(x, comp, noise, out, t, s);
}

template <typename T>
int dispatch(int layout, int mode, int noc, const void* x, const float* comp,
             const float* noise, float* out, const Tile& t, cudaStream_t s) {
  if (layout == kNCHW) return by_chunk<kNCHW, kV2, T>(noc, x, comp, noise, out, t, s);
  return mode == kV1 ? by_chunk<kCHWB, kV1, T>(noc, x, comp, noise, out, t, s)
                     : by_chunk<kCHWB, kV2, T>(noc, x, comp, noise, out, t, s);
}

}  // namespace

extern "C" {

// Launch the wide-span stencil on `stream`. x_dtype: 0 float32, 1 bfloat16.
// layout: 0 NCHW, 1 CHWB. mode: 1 v2, 2 v1 (v2 takes both layouts, v1
// CHWB only). (c, h, w, b) are the image dims, h and w multiples of f;
// comp is [c, k, k] float32; `half` is the tap offset; noise is NULL or
// float32 in the output's layout. (ti, tj, rows, cols, noc) is the tile
// plan: ti x tj outputs a block (NCHW: tj = 32), window rows staged per
// row phase, window columns (NCHW: per column phase), row taps per
// register window (7: the compile-time x2 lattice, f = 2 and ceil(k/f) =
// 7; else 4); ti = tj = rows = cols = 0 selects the global-read kernel.
// Returns 0, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take.
int kmsr_degrade_wide(const void* x, int x_dtype, int layout, int mode,
                      const float* comp, const float* noise, float* out, int c,
                      int h, int w, int b, int f, int k, int half, int ti,
                      int tj, int rows, int cols, int noc, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0 || b <= 0 || f <= 0 || k < f || h % f ||
      w % f || layout < kNCHW || layout > kCHWB || mode < kV2 || mode > kV1 ||
      (mode == kV1 && layout != kCHWB) || x_dtype < 0 || x_dtype > 1 ||
      (noc != 4 && noc != 7)) {
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
  t.n_o = (k + f - 1) / f;
  t.oh = h / f;
  t.ow = w / f;
  t.TI = ti;
  t.TJ = tj;
  t.rows = rows;
  t.cols = cols;
  if (ti == 0 && (tj != 0 || rows != 0 || cols != 0)) return -1;
  if ((int64_t)b * c > 65535 && layout == kNCHW && ti != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == 0 ? dispatch<float>(layout, mode, noc, x, comp, noise, out, t, s)
                      : dispatch<__nv_bfloat16>(layout, mode, noc, x, comp, noise, out, t, s);
}

const char* kmsr_wide_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
