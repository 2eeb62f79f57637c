// Banded stencil-matrix degrade for NVIDIA Hopper (sm_90a), on the tensor
// cores: the counterpart of the Pallas TPU kernel
//   kmsr_tpu/ops/degrade_pallas.py  _degrade_kernel_v4 / _degrade_noise_kernel_v4
// which folds the whole stride-f stencil (replicate padding included) into
// one dense [out_h*out_w, h*w] matrix A per channel and computes
//   out[c] ([out_hw, B]) = sum_{i+j<=2} A_i[c] . x_j[c]  (+ noise)
// with A = A_0 + A_1 + A_2 three bf16 terms split by mantissa masking and x
// split the same way: x_0 = x & 0xFFFF0000, x_1 = (x - x_0) & 0xFFFF0000,
// x_2 = bf16_rn(x - x_0 - x_1). A bfloat16-stored x is its own single term
// (3 products instead of 6). Every bf16 x bf16 product is exact in float32.
//
// A never exists in device memory. A block owns one output tile (one
// output row i, TN = 8*NT output columns from j0; `kmsr_tpu_torch.kernels.
// dense_tiles` builds the table on the host) and writes into shared memory
// the A entries of that tile, and only over the tile's band: the input rows
// y0..y0+nr-1 and columns x0..x0+nc-1 its taps reach (about a third of the
// contraction at 48x48, f=2; everything else in A's rows is zero). Entry
// (output (i, j), pixel (y, x)) is the sequential sum, from 0, of
// comp[dy, dx] over the taps with clamp(f*i+dy-half) = y and
// clamp(f*j+dx-half) = x, dy-major, dx-minor: the order of JAX's scatter
// in `_stencil_matrix` (and of `stencil_matrix`'s unique-index passes), so
// the generated terms equal those of the wrapper-built matrix bit for bit.
// An interior entry holds one tap; a replicate-padded border entry folds
// up to (half+1)^2, a contiguous range of dy times one of dx. So a first,
// straight-line pass writes every entry as an interior one, and a second
// pass rewrites only the band's pixels on an image edge.
//
// The product runs with the batch as the M dimension and the tile's output
// columns as N: out^T[b, n] = sum_p x[p, b] A[n, p], bf16 mma.sync
// m16n8k16 with float32 accumulators (mma.sync rather than wgmma: at
// N = 24 and M = 128 the tile is too small to feed a warpgroup, and the
// kernel is bound by the window's generation and x's split, not by the
// tensor core's rate). 8 warps, 16 batch rows each, cover B = 128 columns
// per pass; a block holds its A window for the whole batch and streams x
// tiles (32 band pixels x 128 batch columns) through a 3-stage cp.async
// ring, each warp splitting its own x fragments once. The six term
// products keep their own accumulators and are summed at the end in JAX's
// loop order (i outer, j inner), then the noise is added. The tensor core
// sums inside each mma in its own order, so the result is held to the
// degrade tolerance (rtol 1e-4 / atol 1e-5), not to bit equality. A band
// too long for shared memory is cut into chunks, its window regenerated
// per batch pass (no shape the repository runs needs that).
//
// Layouts: x is read through (channel, pixel, batch) strides, so CHWB
// ([C, h, w, B]) and NCHW ([B, C, h, w]) both work in place; out and noise
// likewise. CHWB stages batch-contiguous rows, NCHW pixel-contiguous ones;
// a CHWB batch that is not a multiple of 16 bytes is staged element by
// element (as is an x that is not 16-byte aligned). A ragged batch is
// masked.
//
// Bound on an H100 at 48x48, f=2, K=14, B=128, C=5: x, noise and out move
// 8.8 MB (0.0026 ms at 3.35 TB/s); the banded product is 3.4 GFLOP of bf16
// term products (0.0035 ms at 989 TFLOP/s), against 10.2 GFLOP dense.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps x 16 batch rows
constexpr int BT = 128;        // batch columns per pass
constexpr int BK = 32;         // band pixels per pipeline stage
constexpr int kStages = 3;
constexpr int kSmemMax = 232448;  // a block's shared-memory limit on sm_90
constexpr int kTileCols = 6;      // (i, j0, y0, nr, x0, nc) per tile

struct Geo {
  int h, w, B, f, K, half, out_w, kc, ldk;
  int64_t xc, xp, xb;  // x: channel, pixel, batch
  int64_t oc, op, ob;  // out and noise
};

__device__ __forceinline__ float mask_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// three bf16 terms of v: two masked (exact) and the rounded remainder
__device__ __forceinline__ void split3(float v, float& t0, float& t1, float& t2) {
  t0 = mask_hi(v);
  const float r = __fsub_rn(v, t0);
  t1 = mask_hi(r);
  t2 = __fsub_rn(r, t1);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
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

// BATCH_FAST: x's batch stride is 1 (CHWB), stage rows are band pixels of
// BT batch values; else x's pixel stride is 1 (NCHW), stage rows are batch
// columns of BK band pixels.
template <typename T, bool BATCH_FAST>
struct Stage {
  static constexpr int V = 16 / sizeof(T);      // elements per 16-byte copy
  static constexpr int LDB = BT + V;            // batch-fast row (pad: banks)
  static constexpr int LDK = BK + 8;            // pixel-fast row
  static constexpr int SIZE = BATCH_FAST ? BK * LDB : BT * LDK;  // elements
};

template <typename T, bool BATCH_FAST, int NT>
__global__ void __launch_bounds__(kThreads, 1)
degrade_band_kernel(const T* __restrict__ x, const float* __restrict__ comp,
                    const int* __restrict__ tiles,
                    const float* __restrict__ noise, float* __restrict__ out,
                    Geo g, int vec) {
  using S = Stage<T, BATCH_FAST>;
  constexpr int XT = sizeof(T) == 4 ? 3 : 1;  // x terms
  constexpr int TN = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  __nv_bfloat16* sA =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * S::SIZE * sizeof(T));
  float* sComp = reinterpret_cast<float*>(sA + 3 * TN * g.ldk);

  const int c = blockIdx.y;
  const int* tile = tiles + kTileCols * blockIdx.x;
  const int ti = tile[0], j0 = tile[1], y0 = tile[2], nr = tile[3];
  const int x0 = tile[4], nc = tile[5];
  const int band = nr * nc;
  const int n_chunks = (band + g.kc - 1) / g.kc;
  const T* xc = x + c * g.xc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int K = g.K;

  for (int t = tid; t < K * K; t += kThreads) sComp[t] = comp[c * K * K + t];

  // stage `buf` <- band pixels q0 .. q0+BK-1 of batch columns bt0 ..
  // bt0+BT-1 (zeros past the band and the batch)
  auto load_stage = [&](int buf, int q0, int bt0) {
    T* s = sX + buf * S::SIZE;
    if (!vec) {  // element by element, through both strides
      for (int e = tid; e < BK * BT; e += kThreads) {
        const int kk = BATCH_FAST ? e / BT : e % BK;
        const int m = BATCH_FAST ? e % BT : e / BK;
        const int q = q0 + kk;
        T v = T(0.f);
        if (q < band && bt0 + m < g.B) {
          const int64_t p = (int64_t)(y0 + q / nc) * g.w + x0 + q % nc;
          v = xc[p * g.xp + (bt0 + m) * g.xb];
        }
        s[BATCH_FAST ? kk * S::LDB + m : m * S::LDK + kk] = v;
      }
    } else if (BATCH_FAST) {
      for (int e = tid; e < BK * (BT / S::V); e += kThreads) {
        const int kk = e / (BT / S::V), b = (e % (BT / S::V)) * S::V;
        const int q = q0 + kk;
        const bool ok = q < band && bt0 + b < g.B;
        const int64_t p = ok ? (int64_t)(y0 + q / nc) * g.w + x0 + q % nc : 0;
        cp_async16(s + kk * S::LDB + b, ok ? xc + p * g.xp + bt0 + b : xc, ok);
      }
    } else {
      // nc and x0 are multiples of 8, so a 16-byte run stays in one row
      for (int e = tid; e < BT * (BK / S::V); e += kThreads) {
        const int m = e / (BK / S::V), kk = (e % (BK / S::V)) * S::V;
        const int q = q0 + kk;
        const bool ok = q < band && bt0 + m < g.B;
        const int64_t p = ok ? (int64_t)(y0 + q / nc) * g.w + x0 + q % nc : 0;
        cp_async16(s + m * S::LDK + kk, ok ? xc + (bt0 + m) * g.xb + p : xc, ok);
      }
    }
  };

  // A's three terms over band pixels k0 .. k0+kc-1 of this tile, [3][TN][ldk].
  // Entry (n, pixel (y, x)) sums, from 0, comp[dy, dx] over dy in [dy0, dy1]
  // (the taps with clamp(by + dy) == y: one, or a run where y is an image
  // edge) and likewise dx, dy-major.
  auto put = [&](int n, int kl, float a) {
    float t0, t1, t2;
    split3(a, t0, t1, t2);
    const int o = n * g.ldk + kl;
    sA[o] = __float2bfloat16_rn(t0);
    sA[TN * g.ldk + o] = __float2bfloat16_rn(t1);
    sA[2 * TN * g.ldk + o] = __float2bfloat16_rn(t2);
  };
  auto build_window = [&](int k0) {
    const int by = g.f * ti - g.half, bx0 = g.f * j0 - g.half;
    // every band pixel as an interior one, at most one tap per output (a
    // straight line: data-dependent tap loops here cost more than the rest
    // of the window)
    for (int kl = tid; kl < g.kc; kl += kThreads) {
      const int q = k0 + kl;
      const int dy = q < band ? y0 + q / nc - by : -1, xx = x0 + q % nc;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int dx = xx - bx0 - g.f * n;
        put(n, kl, dy >= 0 && dy < K && dx >= 0 && dx < K
                       ? __fadd_rn(0.f, sComp[dy * K + dx]) : 0.f);
      }
    }
    // then the band's pixels on an image edge, whose taps fold: its top
    // and bottom rows where they are image rows 0 and h-1, and between
    // them its first and last columns where they are image columns 0, w-1
    const bool top = y0 == 0, bot = y0 + nr == g.h && !(top && nr == 1);
    const int r0 = top, r1 = nr - bot;  // rows between the edge rows
    const int side = max(r1 - r0, 0);
    const int n_top = top ? nc : 0, n_bot = bot ? nc : 0;
    const int n_left = x0 == 0 ? side : 0, n_right = x0 + nc == g.w ? side : 0;
    const int n_edge = n_top + n_bot + n_left + n_right;
    __syncthreads();  // pass one's entries are written over
    for (int e = tid; e < n_edge * TN; e += kThreads) {
      const int n = e % TN;
      int p = e / TN, r, col;
      if (p < n_top) {
        r = 0, col = p;
      } else if ((p -= n_top) < n_bot) {
        r = nr - 1, col = p;
      } else if ((p -= n_bot) < n_left) {
        r = r0 + p, col = 0;
      } else {
        r = r0 + p - n_left, col = nc - 1;
      }
      const int kl = r * nc + col - k0;
      if (kl < 0 || kl >= g.kc) continue;  // another chunk's pixel
      const int y = y0 + r, xx = x0 + col, bx = bx0 + g.f * n;
      const int dy0 = max(y == 0 ? 0 : y - by, 0);
      const int dy1 = min(y == g.h - 1 ? K - 1 : y - by, K - 1);
      const int dx0 = max(xx == 0 ? 0 : xx - bx, 0);
      const int dx1 = min(xx == g.w - 1 ? K - 1 : xx - bx, K - 1);
      float a = 0.f;
      for (int dy = dy0; dy <= dy1; ++dy)
        for (int dx = dx0; dx <= dx1; ++dx) a = __fadd_rn(a, sComp[dy * K + dx]);
      put(n, kl, a);
    }
  };

  // the warp's x fragment (16 batch rows x 16 band pixels from kl), split
  auto x_frag = [&](const T* s, int kl, uint32_t (&xa)[XT][4]) {
    const int m0 = warp * 16 + gq, k = kl + 2 * tig;
    if constexpr (XT == 3) {
      float v[4][2];  // (m0,k) (m1,k) (m0,k+8) (m1,k+8), each with k+1
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int m = m0 + (f & 1) * 8, kk = k + (f >> 1) * 8;
        if (BATCH_FAST) {
          v[f][0] = s[kk * S::LDB + m];
          v[f][1] = s[(kk + 1) * S::LDB + m];
        } else {
          const float2 p = *reinterpret_cast<const float2*>(s + m * S::LDK + kk);
          v[f][0] = p.x;
          v[f][1] = p.y;
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float a0, a1, a2, b0, b1, b2;
        split3(v[f][0], a0, a1, a2);
        split3(v[f][1], b0, b1, b2);
        xa[0][f] = pack(a0, b0);
        xa[1][f] = pack(a1, b1);
        xa[2][f] = pack(a2, b2);
      }
    } else {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int m = m0 + (f & 1) * 8, kk = k + (f >> 1) * 8;
        xa[0][f] = BATCH_FAST
                       ? pack(s[kk * S::LDB + m], s[(kk + 1) * S::LDB + m])
                       : *reinterpret_cast<const uint32_t*>(s + m * S::LDK + kk);
      }
    }
  };

  for (int bt0 = 0; bt0 < g.B; bt0 += BT) {
    // d[i][j] accumulates A_i . x_j; only i + j <= 2 is used
    float d[3][XT][NT][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < XT; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][j][nt][e] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * g.kc;
      const int nk = (min(g.kc, band - k0) + BK - 1) / BK;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_stage(s, k0 + s * BK, bt0);
        cp_async_commit();
      }
      if (n_chunks > 1 || bt0 == 0) {  // the window, while the stages fly
        __syncthreads();
        build_window(k0);
      }
      for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        {
          const int s = ks + kStages - 1;
          if (s < nk) load_stage(s % kStages, k0 + s * BK, bt0);
          cp_async_commit();
        }
        const T* s = sX + (ks % kStages) * S::SIZE;
#pragma unroll
        for (int kq = 0; kq < BK; kq += 16) {
          uint32_t xa[XT][4];
          x_frag(s, kq, xa);
          const int kl = ks * BK + kq + 2 * tig;
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const __nv_bfloat16* b = sA + (i * TN + nt * 8 + gq) * g.ldk + kl;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
#pragma unroll
              for (int j = 0; j < XT; ++j)
                if (i + j <= 2) mma(d[i][j][nt], xa[j], b0, b1);
            }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage and the window free for the next pass
    }

    // sum the term products in JAX's order (i outer, j inner), add noise
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = d[0][0][nt][e];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < XT; ++j)
            if (i + j <= 2 && (i | j)) v = __fadd_rn(v, d[i][j][nt][e]);
        const int b = bt0 + warp * 16 + gq + (e >> 1) * 8;
        const int j = j0 + nt * 8 + 2 * tig + (e & 1);
        if (b >= g.B) continue;
        const int64_t o = c * g.oc + (int64_t)(ti * g.out_w + j) * g.op + b * g.ob;
        if (noise) v = __fadd_rn(v, noise[o]);
        out[o] = v;
      }
  }
}

template <typename T, bool BATCH_FAST>
constexpr int stage_bytes() {
  return kStages * Stage<T, BATCH_FAST>::SIZE * (int)sizeof(T);
}

template <typename T, bool BATCH_FAST, int NT>
int launch(const void* x, const float* comp, const int* tiles, int n_tiles,
           int max_band, const float* noise, float* out, int c, Geo g, int vec,
           cudaStream_t stream) {
  // the longest band chunk (a multiple of BK) whose window fits beside the
  // x stages and the composed kernel
  const int fixed = stage_bytes<T, BATCH_FAST>() + ((g.K * g.K * 4 + 15) & ~15);
  const int per_k = 3 * NT * 8 * 2;
  int kc = ((kSmemMax - fixed) / per_k - 8) / BK * BK;
  const int band_max = (max_band + BK - 1) / BK * BK;
  if (kc > band_max) kc = band_max;
  if (kc < BK) return -1;
  g.kc = kc;
  g.ldk = kc + 8;  // 16-byte rows whose word stride avoids bank conflicts
  const size_t smem = stage_bytes<T, BATCH_FAST>() + (size_t)3 * NT * 8 * g.ldk * 2 +
                      (size_t)g.K * g.K * 4;
  auto kern = degrade_band_kernel<T, BATCH_FAST, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(n_tiles, c), kThreads, smem, stream>>>(
      static_cast<const T*>(x), comp, tiles, noise, out, g, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool BATCH_FAST>
int by_width(int nt, const void* x, const float* comp, const int* tiles,
             int n_tiles, int max_band, const float* noise, float* out, int c,
             const Geo& g, int vec, cudaStream_t s) {
  switch (nt) {
    case 1:
      return launch<T, BATCH_FAST, 1>(x, comp, tiles, n_tiles, max_band, noise, out, c, g, vec, s);
    case 2:
      return launch<T, BATCH_FAST, 2>(x, comp, tiles, n_tiles, max_band, noise, out, c, g, vec, s);
    default:
      return launch<T, BATCH_FAST, 3>(x, comp, tiles, n_tiles, max_band, noise, out, c, g, vec, s);
  }
}

template <typename T>
int by_layout(bool batch_fast, int nt, const void* x, const float* comp,
              const int* tiles, int n_tiles, int max_band, const float* noise,
              float* out, int c, const Geo& g, cudaStream_t s) {
  // 16-byte copies need 16-byte aligned runs: for NCHW whenever x is (w
  // and the band's x0, nc are multiples of 8); for CHWB when the batch's
  // bytes are a multiple of 16 too
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (!batch_fast || (g.B * (int)sizeof(T)) % 16 == 0);
  return batch_fast
             ? by_width<T, true>(nt, x, comp, tiles, n_tiles, max_band, noise, out, c, g, vec, s)
             : by_width<T, false>(nt, x, comp, tiles, n_tiles, max_band, noise, out, c, g, vec, s);
}

}  // namespace

extern "C" {

// Launch the banded degrade on `stream`: out[c] = sum_{i+j<=2} A_i[c] x_j[c]
// (+ noise), A generated per tile from comp. x_dtype: 0 float32, 1
// bfloat16. comp: [c, k, k] float32. tiles: int32 [n_tiles, 6] on the
// device, (i, j0, y0, nr, x0, nc) per tile of tn output columns (x0, nc
// multiples of 8; max_band the largest nr*nc). (h, w) the image, w and
// w/f multiples of 8 and tn in {8, 16, 24} dividing w/f; n the batch. x is
// read at x[ch*x_cs + p*x_ps + b*x_bs] for pixel p = y*w + x, with x_bs or
// x_ps equal to 1; out and noise (NULL or float32) at [ch*o_cs + q*o_ps +
// b*o_bs] for output pixel q. Returns 0, a cudaError_t code from the
// launch, or -1 for arguments the kernel does not take.
int kmsr_degrade_dense(const void* x, int x_dtype, const float* comp,
                       const int* tiles, int n_tiles, int max_band, int tn,
                       const float* noise, float* out, int c, int h, int w,
                       int n, int f, int k, int64_t x_cs, int64_t x_ps,
                       int64_t x_bs, int64_t o_cs, int64_t o_ps, int64_t o_bs,
                       void* stream) {
  const bool batch_fast = x_bs == 1;
  if (c <= 0 || h <= 0 || w <= 0 || n <= 0 || f <= 0 || k < f || h % f ||
      w % 8 || (w / f) % 8 || tn % 8 || tn < 8 || tn > 24 || (w / f) % tn ||
      n_tiles <= 0 || max_band <= 0 || c > 65535 || x_dtype < 0 ||
      x_dtype > 1 || (!batch_fast && x_ps != 1)) {
    return -1;
  }
  const Geo g{h, w, n, f, k, (k - f) / 2, w / f, 0, 0,
              x_cs, x_ps, x_bs, o_cs, o_ps, o_bs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? by_layout<float>(batch_fast, tn / 8, x, comp, tiles, n_tiles, max_band, noise, out, c, g, st)
             : by_layout<__nv_bfloat16>(batch_fast, tn / 8, x, comp, tiles, n_tiles, max_band, noise, out, c, g, st);
}

const char* kmsr_dense_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
