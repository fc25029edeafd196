// meshcore: native host-side mesh geometry kernels.
//
// The reference leans on matplotlib's C TrapezoidMapTriFinder for per-pixel
// triangle lookup (src/dataloader/mesh_utils.py:104) — the one-off host cost
// that gates dataset preprocessing.  This implements the equivalent with a
// uniform spatial hash over triangle bounding boxes + barycentric inside
// tests, parallelised over grid rows.  Exposed as a C ABI for ctypes.
//
// Built with g++ at first use by fluid_llm_tpu_torch/core/_native.py into
// fluid_llm_tpu_torch/_build/ (a host library: nvcc never sees this file).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Tri {
    double ax, ay, bx, by, cx, cy;
    double d;  // signed twice-area (denominator for barycentrics)
};

inline bool inside(const Tri& t, double px, double py, double tol) {
    const double w0 = ((t.by - t.cy) * (px - t.cx) + (t.cx - t.bx) * (py - t.cy)) / t.d;
    const double w1 = ((t.cy - t.ay) * (px - t.cx) + (t.ax - t.cx) * (py - t.cy)) / t.d;
    const double w2 = 1.0 - w0 - w1;
    return w0 >= -tol && w1 >= -tol && w2 >= -tol;
}

}  // namespace

extern "C" {

// pos: (n_nodes, 2) float64; faces: (n_tri, 3) int32;
// grid_x/grid_y: (h, w) float32 (axis-aligned tensor grid);
// out: (h, w) int32 triangle index or -1.
void meshcore_locate(const double* pos, int64_t n_nodes, const int32_t* faces,
                     int64_t n_tri, const float* grid_x, const float* grid_y,
                     int64_t h, int64_t w, int32_t* out, int32_t n_threads) {
    (void)n_nodes;
    std::vector<Tri> tris(n_tri);
    double x_min = 1e300, x_max = -1e300, y_min = 1e300, y_max = -1e300;
    for (int64_t t = 0; t < n_tri; ++t) {
        const int32_t* f = faces + 3 * t;
        Tri& tr = tris[t];
        tr.ax = pos[2 * f[0]]; tr.ay = pos[2 * f[0] + 1];
        tr.bx = pos[2 * f[1]]; tr.by = pos[2 * f[1] + 1];
        tr.cx = pos[2 * f[2]]; tr.cy = pos[2 * f[2] + 1];
        double d = (tr.by - tr.cy) * (tr.ax - tr.cx) + (tr.cx - tr.bx) * (tr.ay - tr.cy);
        tr.d = (d == 0.0) ? 1e-300 : d;
        x_min = std::min({x_min, tr.ax, tr.bx, tr.cx});
        x_max = std::max({x_max, tr.ax, tr.bx, tr.cx});
        y_min = std::min({y_min, tr.ay, tr.by, tr.cy});
        y_max = std::max({y_max, tr.ay, tr.by, tr.cy});
    }

    // uniform bucket grid sized ~ to triangle count
    const int nbx = std::max<int>(1, (int)std::sqrt((double)n_tri));
    const int nby = std::max<int>(1, (int)std::sqrt((double)n_tri));
    const double sx = nbx / std::max(x_max - x_min, 1e-300);
    const double sy = nby / std::max(y_max - y_min, 1e-300);
    auto bx_of = [&](double x) {
        return std::min(nbx - 1, std::max(0, (int)((x - x_min) * sx)));
    };
    auto by_of = [&](double y) {
        return std::min(nby - 1, std::max(0, (int)((y - y_min) * sy)));
    };

    std::vector<std::vector<int32_t>> buckets((size_t)nbx * nby);
    for (int64_t t = 0; t < n_tri; ++t) {
        const Tri& tr = tris[t];
        const int bx0 = bx_of(std::min({tr.ax, tr.bx, tr.cx}));
        const int bx1 = bx_of(std::max({tr.ax, tr.bx, tr.cx}));
        const int by0 = by_of(std::min({tr.ay, tr.by, tr.cy}));
        const int by1 = by_of(std::max({tr.ay, tr.by, tr.cy}));
        for (int bx = bx0; bx <= bx1; ++bx)
            for (int by = by0; by <= by1; ++by)
                buckets[(size_t)bx * nby + by].push_back((int32_t)t);
    }

    const double tol = 1e-9;
    std::atomic<int64_t> next_row{0};
    auto worker = [&]() {
        for (;;) {
            const int64_t i = next_row.fetch_add(1);
            if (i >= h) return;
            for (int64_t j = 0; j < w; ++j) {
                const double px = grid_x[i * w + j];
                const double py = grid_y[i * w + j];
                int32_t found = -1;
                if (px >= x_min && px <= x_max && py >= y_min && py <= y_max) {
                    const auto& bucket = buckets[(size_t)bx_of(px) * nby + by_of(py)];
                    for (int32_t t : bucket) {
                        if (inside(tris[t], px, py, tol)) { found = t; break; }
                    }
                }
                out[i * w + j] = found;
            }
        }
    };

    int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
    nt = std::max(1, std::min<int>(nt, (int)h));
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int k = 0; k < nt; ++k) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

}  // extern "C"
