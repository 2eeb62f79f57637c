// SwinIR's row normalisation for NVIDIA Hopper (sm_90a): LayerNorm over the
// first C channels of the residual stream f [B, P, Cp] (P = H*W tokens a
// map; Cp >= C the row's width, its Cp - C pad channels zero), with the
// token movement on either side of the window attention folded in.
//
// Replaces no TPU kernel: the JAX package's SwinIR has no Pallas kernel (its
// LayerNorms and token gathers are XLA's). The port added it because the
// plain spelling, F.layer_norm (one block a 360-byte row) plus index_select
// and the residual add, made five passes over the stream an STL where two
// do. Two entry points:
//   norm rows:     y[b, p] = LN(f[b, idx[p]])             (idx NULL: f[b, p])
//   add norm rows: f_out[b, q] = round(f[b, q] + a[b, idx[q]]),
//                  y[b, q] = LN(f_out[b, q])
// with LN(x) = w * (rstd * (x - mean)) + b, mean and the biased variance
// over the first C channels (w and b have C), rstd = rsqrt(var + eps), all
// in float32 for bfloat16 and float32 rows and in float64 for float64 rows
// (F.layer_norm's types; w and b in the row's type), y rounded once to the
// row's type. The pad channels C..Cp-1 of y and of f_out are written 0,
// whatever f and a hold there. f_out is the add in the row's type, as
// PyTorch rounds it (bfloat16: the float32 sum rounded to nearest even), so
// its first C channels are bit-equal to f + a.index_select; the statistics
// are taken on it after the rounding. The mean and variance are two sums
// over the row held in registers (F.layer_norm's Welford differs in the last
// bits of the float32 statistics, so y within an ulp).
//
// Why the pad: the model carries its stream Cp wide (the smallest multiple
// of 8 at or above C; 184 for SwinIR-M's and HAT's 180) so every row is a
// multiple of 16 bytes, which the linears that read and write it need to
// leave cuBLAS's sm80 align2 kernels for Hopper's; this kernel writes those
// rows.
//
// Bound on an H100 at SwinIR-M's stream ([32, 4096, 184] bf16, 48.2 MB):
// norm rows reads f once and writes y, 96.5 MB, 28.8 us at 3.35 TB/s; add
// norm rows reads f and a and writes f_out and y, 193.0 MB, 57.6 us. A few
// operations a byte: the bytes bind (PERF.md's kernel table has the times).
//
// Design: a group of `lpr` lanes (a power of 2, at most a warp) owns one
// row, the smallest group whose lanes hold the norm's part of the row in
// kChunks vectors each (C = 180 bf16: 45 vectors of 8 bytes, 8 lanes of 5
// or 6), so a 256-thread block takes 256 / lpr rows, the statistics need
// only shuffles inside the group, and a lane has several loads in flight
// (its row's vectors, and a's with the add) before it needs the first. At
// C = 180 on an H100 (kChunks 4 to 12 on 4 to 32 lanes a row, tried in one
// run) this plan's 8 lanes of 5 or 6 vectors came within 0.3 % of the
// fastest forward; 16 lanes a row took 1.47x its norm time (the forward
// 15 % slower), a warp 1.4-2.6x. A vector is the widest of 16, 8, 4 or 2
// bytes that divides the norm's C elements, the row's Cp and every
// pointer's alignment (180 bf16 = 360 bytes: 8), so every vector is all
// norm or all pad: the norm's vectors run with no mask, and the pad's
// (one a row at 184) are only written, 0. (On an H100, at the 184 row,
// 16-byte vectors with the vector that holds channel 180 masked, 4 lanes a
// row, took 1.31x the add-norm time of the same masked kernel at 8-byte
// vectors on 8 lanes; and a mask, in either form tried, took the add norm
// 1.21-1.26x the unmasked kernel's time even on unpadded rows: PERF.md.)
// The row is read once into registers, the group's lanes on
// consecutive vectors; the permutation is read once a row (every lane of
// the group the same int64); w and b, every row's, come through the
// read-only cache; the outputs are written once. Norms wider than 32 *
// kChunks vectors (C > 1024 bf16 at 8 bytes) keep the rest in global
// memory and read it again (from L1/L2) in the later passes, so every C is
// taken.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (see kmsr_tpu_torch/kernels/__init__.py); exported as a plain C ABI and
// called through ctypes on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 8;  // vectors a lane keeps in registers

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T>
__device__ __forceinline__ T from_acc(typename AccOf<T>::type v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_acc<double>(double v) { return v; }

__device__ __forceinline__ float rsqrt_acc(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_acc(double v) { return rsqrt(v); }

template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// *p through the read-only data cache
template <typename V>
__device__ __forceinline__ V ldg(const V* p) {
  using R = typename Raw<sizeof(V)>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  V v;
  memcpy(&v, &r, sizeof(V));
  return v;
}

struct Args {
  const void* f;         // [rows, cw]
  const void* a;         // [rows, cw] or NULL (norm rows)
  const int64_t* idx;    // [p] or NULL
  const void* w;         // [c]
  const void* b;         // [c]
  void* f_out;           // [rows, cw] or NULL (norm rows)
  void* y;               // [rows, cw]
  int64_t rows;          // B * P
  int64_t p;             // tokens a map
  int nvec;              // vectors a row (its cw elements)
  int nin;               // of them, the norm's (its c elements); the rest the pad
  int c;
  int lpr;               // lanes a row
  double eps;
};

// the group's sum of v, in every lane of it (lpr divides 32, so a group
// never straddles a warp and xor partners stay inside it)
template <typename A>
__device__ __forceinline__ A group_sum(A v, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int E, bool ADD>
__global__ void __launch_bounds__(kThreads) norm_rows_kernel(const Args args) {
  using A = typename AccOf<T>::type;
  using V = Vec<T, E>;
  const int lane = threadIdx.x & (args.lpr - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / args.lpr;
  // a group past the last row still takes part in its warp's shuffles
  const bool live = row < args.rows;
  const int64_t map0 = live ? row - row % args.p : 0;
  const int64_t tok = live ? row % args.p : 0;
  const int64_t src = args.idx == nullptr ? row : map0 + (live ? args.idx[tok] : 0);
  const int nvec = live ? args.nin : 0;  // the norm's vectors; the pad's are written 0 last
  const V* __restrict__ x = reinterpret_cast<const V*>(args.f) + (ADD ? row : src) * args.nvec;
  const V* __restrict__ g = ADD ? reinterpret_cast<const V*>(args.a) + src * args.nvec : nullptr;
  V* __restrict__ fo = ADD ? reinterpret_cast<V*>(args.f_out) + row * args.nvec : nullptr;
  V* __restrict__ y = reinterpret_cast<V*>(args.y) + row * args.nvec;
  const V* __restrict__ w = reinterpret_cast<const V*>(args.w);
  const V* __restrict__ b = reinterpret_cast<const V*>(args.b);

  // the rounded sum of two vectors, as PyTorch's add rounds it
  auto add = [](V v, const V& o) -> V {
#pragma unroll
    for (int e = 0; e < E; ++e) v.v[e] = from_acc<T>(to_acc(v.v[e]) + to_acc(o.v[e]));
    return v;
  };
  // the row's vector k past the registers: the stream's, or the rounded
  // sum, written to f_out
  auto fetch = [&](int k) -> V {
    if constexpr (ADD) {
      const V v = add(x[k], g[k]);
      fo[k] = v;
      return v;
    } else {
      return x[k];
    }
  };
  // vector k once fetched: from f_out with ADD, else the source row
  auto again = [&](int k) -> V { return ADD ? fo[k] : x[k]; };

  // every load of the registers' vectors issued before the first store
  V buf[kChunks];
  V other[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int k = lane + i * args.lpr;
    if (k < nvec) {
      buf[i] = x[k];
      if constexpr (ADD) other[i] = g[k];
    }
  }
  A sum = 0;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int k = lane + i * args.lpr;
    if (k < nvec) {
      if constexpr (ADD) {
        buf[i] = add(buf[i], other[i]);
        fo[k] = buf[i];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sum += to_acc(buf[i].v[e]);
    }
  }
  for (int k = lane + kChunks * args.lpr; k < nvec; k += args.lpr) {
    const V v = fetch(k);
#pragma unroll
    for (int e = 0; e < E; ++e) sum += to_acc(v.v[e]);
  }
  const A mean = group_sum(sum, args.lpr) / static_cast<A>(args.c);

  A ss = 0;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + i * args.lpr < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const A d = to_acc(buf[i].v[e]) - mean;
        ss += d * d;
      }
    }
  }
  for (int k = lane + kChunks * args.lpr; k < nvec; k += args.lpr) {
    const V v = again(k);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const A d = to_acc(v.v[e]) - mean;
      ss += d * d;
    }
  }
  const A var = group_sum(ss, args.lpr) / static_cast<A>(args.c);
  const A rstd = rsqrt_acc(var + static_cast<A>(args.eps));

  // y's vector k; w and b (every row's, so L1's) through the read-only path
  auto put = [&](int k, const V& v) {
    const V wk = ldg(w + k), bk = ldg(b + k);
    V o;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      o.v[e] = from_acc<T>(to_acc(wk.v[e]) * (rstd * (to_acc(v.v[e]) - mean)) + to_acc(bk.v[e]));
    }
    y[k] = o;
  };
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int k = lane + i * args.lpr;
    if (k < nvec) put(k, buf[i]);
  }
  for (int k = lane + kChunks * args.lpr; k < nvec; k += args.lpr) put(k, again(k));
  // the pad's vectors, past the norm's: 0, in y and in f_out
  if (live) {
    V z;
#pragma unroll
    for (int e = 0; e < E; ++e) z.v[e] = from_acc<T>(static_cast<A>(0));
    for (int k = args.nin + lane; k < args.nvec; k += args.lpr) {
      y[k] = z;
      if constexpr (ADD) fo[k] = z;
    }
  }
}

template <typename T, int E>
int launch(bool add, const Args& args, cudaStream_t s) {
  const int64_t per_block = kThreads / args.lpr;
  const int64_t blocks = (args.rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return -1;
  if (add) {
    norm_rows_kernel<T, E, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(args);
  } else {
    norm_rows_kernel<T, E, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(int vec_bytes, bool add, const Args& args, cudaStream_t s) {
  constexpr int sz = static_cast<int>(sizeof(T));
  switch (vec_bytes) {
    case 16: return launch<T, 16 / sz>(add, args, s);
    case 8: return launch<T, 8 / sz>(add, args, s);
    case 4: if constexpr (sz <= 4) return launch<T, 4 / sz>(add, args, s); else return -1;
    case 2: if constexpr (sz <= 2) return launch<T, 2 / sz>(add, args, s); else return -1;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launch SwinIR's row norm on `stream`. dtype: 0 float32, 1 bfloat16, 2
// float64, for every tensor. f, y (and a, f_out with add = 1) are [rows, cw]
// row-major, rows = B * p; the norm is over each row's first c channels
// (c <= cw), the other cw - c written 0; idx NULL or int64 [p], a
// permutation of the p tokens of a map, read for every map (norm rows: the
// source of y's row; add norm rows: a's row added); w and b [c]. vec_bytes
// (16, 8, 4 or 2, at least the element's size) divides c's bytes, cw's
// bytes and every pointer's alignment, so a vector is all norm or all pad;
// lpr (1, 2, ..., 32) lanes a row. Returns 0, a cudaError_t code from the
// launch, or -1 for arguments the kernel does not take.
int kmsr_swin_norm(int add, int dtype, const void* f, const void* a,
                   const int64_t* idx, const void* w, const void* b,
                   void* f_out, void* y, int64_t rows, int64_t p, int c, int cw,
                   int vec_bytes, int lpr, double eps, void* stream) {
  const int sz = dtype == 2 ? 8 : dtype == 1 ? 2 : 4;
  if (dtype < 0 || dtype > 2 || rows <= 0 || p <= 0 || rows % p || c <= 0 || cw < c ||
      vec_bytes < sz || (static_cast<int64_t>(c) * sz) % vec_bytes ||
      (static_cast<int64_t>(cw) * sz) % vec_bytes || lpr < 1 || lpr > 32 ||
      (lpr & (lpr - 1)) || f == nullptr || w == nullptr || b == nullptr || y == nullptr ||
      (add && (a == nullptr || f_out == nullptr || idx == nullptr))) {
    return -1;
  }
  Args args{f, a, idx, w, b, f_out, y, rows, p,
            static_cast<int>(static_cast<int64_t>(cw) * sz / vec_bytes),
            static_cast<int>(static_cast<int64_t>(c) * sz / vec_bytes), c, lpr, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_width<float>(vec_bytes, add != 0, args, s);
    case 1: return by_width<__nv_bfloat16>(vec_bytes, add != 0, args, s);
    default: return by_width<double>(vec_bytes, add != 0, args, s);
  }
}

const char* kmsr_swin_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
