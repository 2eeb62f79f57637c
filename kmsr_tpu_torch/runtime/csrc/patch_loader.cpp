// Threaded prefetching .npy patch loader — the native host-runtime piece of
// the data factory.
//
// The reference's training loops re-open and re-parse ~32 NetCDF files from
// Python on EVERY iteration (single_kernel/train.py:255-268), serially.
// This loader keeps a worker pool that gathers an index batch of float32
// .npy patches straight from the page cache into a caller buffer, and
// supports asynchronous prefetch of the NEXT batch while the device step
// runs. (The port's copy of kmsr_tpu/runtime/csrc/patch_loader.cpp.)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Supported payload: .npy v1.x, little-endian '<f4', C-order, fixed shape.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  std::string path;
  uint64_t data_offset = 0;
  uint64_t n_floats = 0;
};

bool parse_npy_header(const std::string& path, uint64_t expect_floats,
                      NpyInfo* out, std::string* err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    *err = "bad npy magic: " + path;
    std::fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (std::fread(hl, 1, 2, f) != 2) { std::fclose(f); *err = "short header"; return false; }
    header_len = hl[0] | (hl[1] << 8);
    out->data_offset = 10 + header_len;
  } else {
    unsigned char hl[4];
    if (std::fread(hl, 1, 4, f) != 4) { std::fclose(f); *err = "short header"; return false; }
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) | (hl[3] << 24);
    out->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (std::fread(header.data(), 1, header_len, f) != header_len) {
    std::fclose(f);
    *err = "short header body";
    return false;
  }
  std::fclose(f);
  if (header.find("'<f4'") == std::string::npos &&
      header.find("\"<f4\"") == std::string::npos) {
    *err = "dtype is not <f4: " + path;
    return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    *err = "fortran order unsupported: " + path;
    return false;
  }
  out->path = path;
  out->n_floats = expect_floats;
  return true;
}

// Pre-split output layout parameters (factor > 0 selects split mode).
// The gathered batch is written as [C, f, H/f + 2*halo, W, B]: rows
// regrouped by row-phase p = y % f, columns permuted to
// v = (x % f)*(W/f) + x//f, batch in the minor dimension. halo=0 is the
// layout `ops.degrade_fused.degrade_fused_presplit` consumes directly
// (its kernel rebuilds the replicate padding from clamped indices);
// halo=1 bakes one replicate halo row (image rows 0 / H-1) at each end
// of the row axis, the layout of the JAX package's baked-halo kernel.
// Assembling either order costs the host nothing extra: a CHWB batch
// buffer is a scatter per patch either way, this is just a different
// write order.
struct SplitSpec {
  int c = 0, h = 0, w = 0, factor = 0, halo = 1;
  // When set, the natural [B, C, H, W] batch is ALSO written here from
  // the same staging read — one file read fills both layouts (the
  // factory needs the natural patch to write the hr group).
  float* natural_out = nullptr;
};

struct Loader {
  std::vector<NpyInfo> files;
  uint64_t patch_floats = 0;
  int n_threads = 4;
  std::string last_error;

  // async prefetch state
  std::thread prefetch_thread;
  std::vector<int64_t> pending_indices;
  float* pending_out = nullptr;
  SplitSpec pending_split;
  std::atomic<bool> prefetch_running{false};
  std::atomic<int> prefetch_status{0};

  bool read_one(int64_t idx, float* dst) {
    if (idx < 0 || idx >= (int64_t)files.size()) {
      last_error = "index out of range";
      return false;
    }
    const NpyInfo& info = files[idx];
    FILE* f = std::fopen(info.path.c_str(), "rb");
    if (!f) {
      last_error = "open failed: " + info.path;
      return false;
    }
    bool ok = std::fseek(f, (long)info.data_offset, SEEK_SET) == 0 &&
              std::fread(dst, sizeof(float), patch_floats, f) == patch_floats;
    std::fclose(f);
    if (!ok) last_error = "short read: " + info.path;
    return ok;
  }

  // Scatter one [C, H, W] patch (in `src`) into batch column `i` of the
  // pre-split [C, f, H/f + 2*halo, W, B] buffer `out`.
  static void scatter_split(const float* src, float* out, int i, int n,
                            const SplitSpec& s) {
    const int out_h = s.h / s.factor;
    const int out_w = s.w / s.factor;
    const int rows = out_h + 2 * s.halo;
    const uint64_t row_floats = (uint64_t)s.w * n;
    const int y_lo = s.halo ? -1 : 0;
    const int y_hi = s.halo ? s.h : s.h - 1;
    for (int ci = 0; ci < s.c; ++ci) {
      const float* plane = src + (uint64_t)ci * s.h * s.w;
      float* oc = out + (uint64_t)ci * s.factor * rows * row_floats;
      for (int y = y_lo; y <= y_hi; ++y) {
        // y == -1 / y == h are the replicate halo rows; they duplicate
        // image rows 0 / h-1 into row slot 0 / out_h+1 of EVERY phase.
        const int ysrc = y < 0 ? 0 : (y >= s.h ? s.h - 1 : y);
        const float* row = plane + (uint64_t)ysrc * s.w;
        const int p_lo = (y < 0 || y >= s.h) ? 0 : y % s.factor;
        const int p_hi = (y < 0 || y >= s.h) ? s.factor - 1 : p_lo;
        const int slot =
            y < 0 ? 0 : (y >= s.h ? out_h + 1 : s.halo + y / s.factor);
        for (int p = p_lo; p <= p_hi; ++p) {
          float* orow = oc + ((uint64_t)p * rows + slot) * row_floats;
          for (int dxi = 0; dxi < s.factor; ++dxi) {
            const float* sx = row + dxi;                     // stride f
            float* ox = orow + (uint64_t)dxi * out_w * n + i;  // stride n
            for (int j = 0; j < out_w; ++j) ox[(uint64_t)j * n] = sx[(uint64_t)j * s.factor];
          }
        }
      }
    }
  }

  bool gather(const int64_t* indices, int n, float* out,
              const SplitSpec& split) {
    if (split.factor > 0) {
      if ((uint64_t)split.c * split.h * split.w != patch_floats ||
          split.h % split.factor || split.w % split.factor) {
        last_error = "split spec does not match patch shape";
        return false;
      }
    }
    std::atomic<int> next{0};
    std::atomic<bool> ok{true};
    int workers = std::min(n_threads, n);
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) {
      pool.emplace_back([&] {
        std::vector<float> staging;
        if (split.factor > 0) staging.resize(patch_floats);
        int i;
        while ((i = next.fetch_add(1)) < n) {
          if (split.factor > 0) {
            if (!read_one(indices[i], staging.data())) { ok = false; return; }
            scatter_split(staging.data(), out, i, n, split);
            if (split.natural_out) {
              std::memcpy(split.natural_out + (uint64_t)i * patch_floats,
                          staging.data(), patch_floats * sizeof(float));
            }
          } else if (!read_one(indices[i], out + (uint64_t)i * patch_floats)) {
            ok = false;
            return;
          }
        }
      });
    }
    for (auto& t : pool) t.join();
    return ok.load();
  }
};

}  // namespace

extern "C" {

void* kmsr_loader_create(const char** paths, int n_paths, int64_t patch_floats,
                         int n_threads) {
  auto* ld = new Loader();
  ld->patch_floats = (uint64_t)patch_floats;
  ld->n_threads = n_threads > 0 ? n_threads : 4;
  ld->files.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) {
    NpyInfo info;
    std::string err;
    if (!parse_npy_header(paths[i], patch_floats, &info, &err)) {
      ld->last_error = err;
      delete ld;
      return nullptr;
    }
    ld->files.push_back(std::move(info));
  }
  return ld;
}

int kmsr_loader_gather(void* handle, const int64_t* indices, int n, float* out) {
  auto* ld = static_cast<Loader*>(handle);
  return ld->gather(indices, n, out, SplitSpec{}) ? 0 : 1;
}

// Gather straight into the pre-split degrade layout
// [C, f, H/f + 2*halo, W, n] (see SplitSpec above); patches must be
// [c, h, w] with c*h*w matching the loader's patch_floats.
int kmsr_loader_gather_split(void* handle, const int64_t* indices, int n,
                             int c, int h, int w, int factor, int halo,
                             float* out) {
  auto* ld = static_cast<Loader*>(handle);
  return ld->gather(indices, n, out, SplitSpec{c, h, w, factor, halo}) ? 0 : 1;
}

// Dual gather: one file read fills BOTH the pre-split layout (`out`) and
// the natural [n, C, H, W] batch (`natural_out`).
int kmsr_loader_gather_split_dual(void* handle, const int64_t* indices,
                                  int n, int c, int h, int w, int factor,
                                  int halo, float* out, float* natural_out) {
  auto* ld = static_cast<Loader*>(handle);
  return ld->gather(indices, n, out,
                    SplitSpec{c, h, w, factor, halo, natural_out}) ? 0 : 1;
}

namespace {

// Shared async-prefetch setup. A finished-but-unjoined previous thread is
// joined first: move-assigning onto a joinable std::thread would call
// std::terminate (reachable from the C ABI by skipping kmsr_loader_wait
// between two prefetch calls).
int start_prefetch(Loader* ld, const int64_t* indices, int n, float* out,
                   SplitSpec split) {
  if (ld->prefetch_running.load()) return 2;  // one prefetch at a time
  if (ld->prefetch_thread.joinable()) ld->prefetch_thread.join();
  ld->pending_indices.assign(indices, indices + n);
  ld->pending_out = out;
  ld->pending_split = split;
  ld->prefetch_running = true;
  ld->prefetch_status = -1;
  ld->prefetch_thread = std::thread([ld, n] {
    bool ok = ld->gather(ld->pending_indices.data(), n, ld->pending_out,
                         ld->pending_split);
    ld->prefetch_status = ok ? 0 : 1;
    ld->prefetch_running = false;
  });
  return 0;
}

}  // namespace

// Start asynchronously gathering `indices` into `out` (caller keeps both
// alive until kmsr_loader_wait returns).
int kmsr_loader_prefetch(void* handle, const int64_t* indices, int n, float* out) {
  return start_prefetch(static_cast<Loader*>(handle), indices, n, out,
                        SplitSpec{});
}

int kmsr_loader_prefetch_split(void* handle, const int64_t* indices, int n,
                               int c, int h, int w, int factor, int halo,
                               float* out) {
  return start_prefetch(static_cast<Loader*>(handle), indices, n, out,
                        SplitSpec{c, h, w, factor, halo});
}

int kmsr_loader_prefetch_split_dual(void* handle, const int64_t* indices,
                                    int n, int c, int h, int w, int factor,
                                    int halo, float* out, float* natural_out) {
  return start_prefetch(static_cast<Loader*>(handle), indices, n, out,
                        SplitSpec{c, h, w, factor, halo, natural_out});
}

int kmsr_loader_wait(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->prefetch_thread.joinable()) ld->prefetch_thread.join();
  return ld->prefetch_status.load();
}

int64_t kmsr_loader_num_files(void* handle) {
  return (int64_t)static_cast<Loader*>(handle)->files.size();
}

const char* kmsr_loader_last_error(void* handle) {
  return static_cast<Loader*>(handle)->last_error.c_str();
}

void kmsr_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->prefetch_thread.joinable()) ld->prefetch_thread.join();
  delete ld;
}

}  // extern "C"
