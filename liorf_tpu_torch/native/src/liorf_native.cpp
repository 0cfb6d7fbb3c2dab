// liorf_tpu_torch native host runtime (the JAX package's liorf_native.cpp).
//
// The reference's runtime around the math is C++ (ROS nodelets, PCL readers,
// rosbag transport). The port keeps the *compute* in PyTorch and its CUDA
// kernels and implements the host-side ingest path natively here:
//
//   * strided PointCloud2 field extraction (AoS -> SoA float32 columns),
//     the hot loop of bag decoding;
//   * bz2 chunk decompression (rosbag chunks) via a dlopen'd libbz2 —
//     the environment ships the .so but no headers;
//   * a threaded file prefetcher that reads+decodes scan files ahead of
//     the device feed (the host-side analogue of the reference's
//     multi-process pipeline).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <dlfcn.h>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PointCloud2 strided extraction
// ---------------------------------------------------------------------------
// dtype codes follow sensor_msgs/PointField: 1..8
//   INT8=1 UINT8=2 INT16=3 UINT16=4 INT32=5 UINT32=6 FLOAT32=7 FLOAT64=8

static inline float load_field(const uint8_t* p, int dtype) {
    switch (dtype) {
        case 1: return (float)*(const int8_t*)p;
        case 2: return (float)*(const uint8_t*)p;
        case 3: { int16_t v; memcpy(&v, p, 2); return (float)v; }
        case 4: { uint16_t v; memcpy(&v, p, 2); return (float)v; }
        case 5: { int32_t v; memcpy(&v, p, 4); return (float)v; }
        case 6: { uint32_t v; memcpy(&v, p, 4); return (float)v; }
        case 7: { float v; memcpy(&v, p, 4); return v; }
        case 8: { double v; memcpy(&v, p, 8); return (float)v; }
        default: return 0.0f;
    }
}

// Extract n_fields strided columns into out (n_fields * n floats, column
// major: out[f * n + i]). Returns 0 on success.
int ln_pc2_extract(const uint8_t* data, int64_t n, int32_t point_step,
                   const int32_t* offsets, const int32_t* dtypes,
                   int32_t n_fields, float* out) {
    if (!data || !out || n < 0 || point_step <= 0) return -1;
    for (int32_t f = 0; f < n_fields; ++f) {
        const int32_t off = offsets[f];
        const int32_t dt = dtypes[f];
        float* dst = out + (int64_t)f * n;
        const uint8_t* src = data + off;
        for (int64_t i = 0; i < n; ++i) {
            dst[i] = load_field(src + i * (int64_t)point_step, dt);
        }
    }
    return 0;
}

// Pack a raw scan into fixed-capacity padded buffers in one pass:
// squared-range gate (NaN/inf fail the comparison), ring decimation,
// point stride, then write xyz / rel-time / mask(0|1 as f32) directly
// into the fused frame-input buffer slices (pipeline/resident.py).
// Replaces the numpy two-pass filter (~0.9 ms -> ~0.1 ms per 28k-pt scan,
// the host being the pipeline's critical path). Returns kept count.
// Returns the TOTAL number of points passing the filters (which may exceed
// cap — callers compare against cap to detect truncation); writes at most
// cap packed points. msk_out may be NULL when the caller derives the mask
// from the kept count (the packed layout is compact).
int64_t ln_pack_scan(const float* xyz, const double* rel, const int32_t* ring,
                     int64_t n, float min_r2, float max_r2,
                     int32_t dsr, int32_t pfn, int64_t cap,
                     float* xyz_out, float* rts_out, float* msk_out) {
    if (!xyz || !xyz_out || !rts_out) return -1;
    int64_t k = 0, tot = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        const float d2 = x * x + y * y + z * z;
        if (!(d2 >= min_r2 && d2 <= max_r2)) continue;  // NaN/inf fail here
        if (dsr > 1 && ring && (ring[i] % dsr) != 0) continue;
        if (pfn > 1 && (i % pfn) != 0) continue;
        ++tot;
        if (k >= cap) continue;  // keep counting for truncation detection
        xyz_out[3 * k] = x;
        xyz_out[3 * k + 1] = y;
        xyz_out[3 * k + 2] = z;
        rts_out[k] = rel ? (float)rel[i] : 0.0f;
        if (msk_out) msk_out[k] = 1.0f;
        ++k;
    }
    for (int64_t j = k; j < cap; ++j) {  // PAD_COORD = 1e7 (core/pointcloud.py)
        xyz_out[3 * j] = 1.0e7f;
        xyz_out[3 * j + 1] = 1.0e7f;
        xyz_out[3 * j + 2] = 1.0e7f;
        rts_out[j] = 0.0f;
        if (msk_out) msk_out[j] = 0.0f;
    }
    return tot;
}

// Extract a float64 column (for robosense absolute per-point stamps).
int ln_pc2_extract_f64(const uint8_t* data, int64_t n, int32_t point_step,
                       int32_t offset, double* out) {
    if (!data || !out || n < 0 || point_step <= 0) return -1;
    const uint8_t* src = data + offset;
    for (int64_t i = 0; i < n; ++i) {
        double v;
        memcpy(&v, src + i * (int64_t)point_step, 8);
        out[i] = v;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// bz2 decompression via dlopen (no headers in the image; ABI is stable)
// ---------------------------------------------------------------------------

typedef int (*bz2_decompress_fn)(char* dest, unsigned* destLen,
                                 char* source, unsigned sourceLen,
                                 int small, int verbosity);

static bz2_decompress_fn get_bz2() {
    static bz2_decompress_fn fn = [] {
        void* h = dlopen("libbz2.so.1.0", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libbz2.so.1", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libbz2.so", RTLD_NOW | RTLD_GLOBAL);
        if (!h) return (bz2_decompress_fn) nullptr;
        return (bz2_decompress_fn)dlsym(h, "BZ2_bzBuffToBuffDecompress");
    }();
    return fn;
}

// Returns decompressed length, or -1 on failure. dest_cap must be large
// enough (rosbag chunk headers carry the uncompressed size).
int64_t ln_bz2_decompress(const uint8_t* src, int64_t src_len,
                          uint8_t* dest, int64_t dest_cap) {
    bz2_decompress_fn fn = get_bz2();
    if (!fn) return -1;
    unsigned out_len = (unsigned)dest_cap;
    int rc = fn((char*)dest, &out_len, (char*)src, (unsigned)src_len, 0, 0);
    if (rc != 0) return -1;
    return (int64_t)out_len;
}

int ln_has_bz2() { return get_bz2() != nullptr; }

// ---------------------------------------------------------------------------
// Threaded file prefetcher
// ---------------------------------------------------------------------------

struct Prefetcher {
    std::vector<std::string> paths;
    size_t next_submit = 0;
    size_t depth;
    std::deque<std::pair<size_t, std::vector<uint8_t>>> ready;  // ordered
    std::mutex mu;
    std::condition_variable cv;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};
    std::deque<size_t> queue;  // indices to read

    explicit Prefetcher(std::vector<std::string> p, int n_threads, int d)
        : paths(std::move(p)), depth((size_t)d) {
        for (size_t i = 0; i < paths.size(); ++i) queue.push_back(i);
        for (int t = 0; t < n_threads; ++t)
            workers.emplace_back([this] { run(); });
    }

    void run() {
        for (;;) {
            size_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] {
                    return stop || (!queue.empty() && ready.size() < depth);
                });
                if (stop) return;
                idx = queue.front();
                queue.pop_front();
            }
            std::vector<uint8_t> buf;
            FILE* f = fopen(paths[idx].c_str(), "rb");
            if (f) {
                fseek(f, 0, SEEK_END);
                long len = ftell(f);
                fseek(f, 0, SEEK_SET);
                buf.resize((size_t)len);
                if (fread(buf.data(), 1, (size_t)len, f) != (size_t)len)
                    buf.clear();
                fclose(f);
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.emplace_back(idx, std::move(buf));
            }
            cv.notify_all();
        }
    }

    ~Prefetcher() {
        stop = true;
        cv.notify_all();
        for (auto& w : workers) w.join();
    }
};

void* ln_prefetcher_create(const char** paths, int n_paths, int n_threads,
                           int depth) {
    std::vector<std::string> p(paths, paths + n_paths);
    return new Prefetcher(std::move(p), n_threads, depth);
}

// Blocks until file `idx` is available; copies into out (cap bytes).
// Returns the file length, or -1. Files must be consumed roughly in order.
int64_t ln_prefetcher_get(void* pf_, int64_t idx, uint8_t* out, int64_t cap) {
    auto* pf = (Prefetcher*)pf_;
    std::unique_lock<std::mutex> lk(pf->mu);
    for (;;) {
        for (auto it = pf->ready.begin(); it != pf->ready.end(); ++it) {
            if (it->first == (size_t)idx) {
                int64_t len = (int64_t)it->second.size();
                if (len <= cap) memcpy(out, it->second.data(), (size_t)len);
                pf->ready.erase(it);
                pf->cv.notify_all();
                return len;
            }
        }
        pf->cv.wait(lk);
    }
}

// Peek a file's size without consuming (blocks until loaded).
int64_t ln_prefetcher_size(void* pf_, int64_t idx) {
    auto* pf = (Prefetcher*)pf_;
    std::unique_lock<std::mutex> lk(pf->mu);
    for (;;) {
        for (auto& e : pf->ready)
            if (e.first == (size_t)idx) return (int64_t)e.second.size();
        pf->cv.wait(lk);
    }
}

void ln_prefetcher_destroy(void* pf_) { delete (Prefetcher*)pf_; }

}  // extern "C"
