// Native host-side buffer utilities (reference: csrc/flatten_unflatten.cpp
// — apex_C.flatten/unflatten — and the host copy the JAX package keeps in
// apex_tpu/_native/apex_c.cpp).
//
// Host C++, no CUDA: checkpoint payload packing and unpacking (a threaded
// memcpy of many buffers into one) and the f32 checksum of a checkpoint
// (a threaded f64 sum of squares).  Built with g++ -O3 -shared at first use
// (apex_tpu_torch/_build.py, host_library).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// Pack n buffers (ptrs[i], nbytes[i]) into dst contiguously, threaded.
void apex_c_flatten(const void** ptrs, const int64_t* nbytes, int64_t n,
                    void* dst, int64_t n_threads) {
    std::vector<int64_t> offsets(n + 1, 0);
    for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t tid) {
        for (int64_t i = tid; i < n; i += n_threads) {
            std::memcpy(static_cast<char*>(dst) + offsets[i], ptrs[i],
                        static_cast<size_t>(nbytes[i]));
        }
    };
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < n_threads; ++t) ts.emplace_back(worker, t);
    worker(0);
    for (auto& t : ts) t.join();
}

// Scatter src back into n buffers (the unflatten inverse).
void apex_c_unflatten(const void* src, const int64_t* nbytes, int64_t n,
                      void** ptrs, int64_t n_threads) {
    std::vector<int64_t> offsets(n + 1, 0);
    for (int64_t i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t tid) {
        for (int64_t i = tid; i < n; i += n_threads) {
            std::memcpy(ptrs[i],
                        static_cast<const char*>(src) + offsets[i],
                        static_cast<size_t>(nbytes[i]));
        }
    };
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < n_threads; ++t) ts.emplace_back(worker, t);
    worker(0);
    for (auto& t : ts) t.join();
}

// Threaded squared-L2 over a float32 buffer (host-side multi_tensor_l2norm
// for checkpoint verification / bucket checksums).
double apex_c_l2norm_sq_f32(const float* x, int64_t n, int64_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::vector<double> partial(static_cast<size_t>(n_threads), 0.0);
    auto worker = [&](int64_t tid) {
        int64_t chunk = (n + n_threads - 1) / n_threads;
        int64_t lo = tid * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        double acc = 0.0;
        for (int64_t i = lo; i < hi; ++i) {
            double v = static_cast<double>(x[i]);
            acc += v * v;
        }
        partial[static_cast<size_t>(tid)] = acc;
    };
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < n_threads; ++t) ts.emplace_back(worker, t);
    worker(0);
    for (auto& t : ts) t.join();
    double total = 0.0;
    for (double p : partial) total += p;
    return total;
}

}  // extern "C"
