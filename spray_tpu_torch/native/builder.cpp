// Host build hot loops of the cluster pages, a copy of the reference's
// spray_tpu/native/builder.cpp: Morton ordering of triangle centroids and the
// per-triangle world->unit-triangle affine inverses (Woop transforms), in
// double precision.  spray_tpu_torch/kernels/cluster_bvh.py has the numpy
// fallback, which computes the same formula in float64 and equals this bit
// for bit.
//
// Build: spray_tpu_torch/native/__init__.py (g++ -O3 -ffp-contract=off, into
// build/native/).  ABI: plain C, consumed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint64_t spread3(uint64_t v) {
    v &= 0x3FF;  // 10 bits
    v = (v | (v << 32)) & 0x1F00000000FFFFull;
    v = (v | (v << 16)) & 0x1F0000FF0000FFull;
    v = (v | (v << 8)) & 0x100F00F00F00F00Full;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
    v = (v | (v << 2)) & 0x1249249249249249ull;
    return v;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = std::max<int64_t>(
        1, std::min<int64_t>(hw ? hw : 1, n / 65536));
    if (nthreads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; t++) {
        int64_t a = t * chunk, b = std::min(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back(fn, a, b);
    }
    for (auto& t : ts) t.join();
}

inline void cross3(const double* x, const double* y, double* out) {
    out[0] = x[1] * y[2] - x[2] * y[1];
    out[1] = x[2] * y[0] - x[0] * y[2];
    out[2] = x[0] * y[1] - x[1] * y[0];
}

}  // namespace

extern "C" {

// Morton order of triangle centroids.  tlo/thi: (n,3) f32 row-major tri
// bounds; order_out: (n,) int64 permutation (ascending Morton code).
void spray_morton_order(const float* tlo, const float* thi, int64_t n,
                        int64_t* order_out) {
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    std::vector<float> cx(n), cy(n), cz(n);
    for (int64_t i = 0; i < n; i++) {
        float c0 = 0.5f * (tlo[3 * i + 0] + thi[3 * i + 0]);
        float c1 = 0.5f * (tlo[3 * i + 1] + thi[3 * i + 1]);
        float c2 = 0.5f * (tlo[3 * i + 2] + thi[3 * i + 2]);
        cx[i] = c0;
        cy[i] = c1;
        cz[i] = c2;
        lo[0] = std::min(lo[0], c0);
        hi[0] = std::max(hi[0], c0);
        lo[1] = std::min(lo[1], c1);
        hi[1] = std::max(hi[1], c1);
        lo[2] = std::min(lo[2], c2);
        hi[2] = std::max(hi[2], c2);
    }
    float ext[3];
    for (int k = 0; k < 3; k++) ext[k] = std::max(hi[k] - lo[k], 1e-12f);
    std::vector<std::pair<uint64_t, int64_t>> keyed(n);
    parallel_for(n, [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++) {
            auto q = [&](float c, int k) -> uint64_t {
                float t = (c - lo[k]) / ext[k] * 1023.0f;
                int64_t v = (int64_t)t;
                return (uint64_t)std::max<int64_t>(
                    0, std::min<int64_t>(1023, v));
            };
            uint64_t code = spread3(q(cx[i], 0)) |
                            (spread3(q(cy[i], 1)) << 1) |
                            (spread3(q(cz[i], 2)) << 2);
            keyed[i] = {code, i};
        }
    });
    std::sort(keyed.begin(), keyed.end());
    for (int64_t i = 0; i < n; i++) order_out[i] = keyed[i].second;
}

// Per-triangle Woop transforms matching kernels/cluster_bvh.tri_transforms:
// out[i] is (4,3): out[i, r, k] = A[k][r] for r<3 (A = [e1 e2 n]^-1 rows),
// out[i, 3, k] = -(A[k] . v0).  Degenerate tris -> never-hit transform.
void spray_tri_transforms(const float* v0, const float* e1, const float* e2,
                          int64_t n, float* out) {
    parallel_for(n, [&](int64_t lo_i, int64_t hi_i) {
        for (int64_t i = lo_i; i < hi_i; i++) {
            double a[3] = {e1[3 * i], e1[3 * i + 1], e1[3 * i + 2]};
            double b[3] = {e2[3 * i], e2[3 * i + 1], e2[3 * i + 2]};
            double c[3];
            cross3(a, b, c);  // unnormalized normal = third column
            // det(M) with M = [a | b | c]: a . (b x c)
            double bxc[3];
            cross3(b, c, bxc);
            double det = a[0] * bxc[0] + a[1] * bxc[1] + a[2] * bxc[2];
            float* o = out + 12 * i;
            if (std::fabs(det) < 1e-18) {
                std::memset(o, 0, 12 * sizeof(float));
                o[11] = 1.0f;  // O'w = 1, D'w = 0 -> t = -inf, never hits
                continue;
            }
            double inv = 1.0 / det;
            // M^-1 rows = adjugate rows / det = cross products of columns:
            // row0 = (b x c)/det, row1 = (c x a)/det, row2 = (a x b)/det
            double cxa[3];
            cross3(c, a, cxa);
            double A[3][3];
            for (int k = 0; k < 3; k++) {
                A[0][k] = bxc[k] * inv;
                A[1][k] = cxa[k] * inv;
                A[2][k] = c[k] * inv;  // a x b == c
            }
            const float* p = v0 + 3 * i;
            for (int r = 0; r < 3; r++) {
                o[3 * r + 0] = (float)A[0][r];
                o[3 * r + 1] = (float)A[1][r];
                o[3 * r + 2] = (float)A[2][r];
            }
            for (int k = 0; k < 3; k++) {
                o[9 + k] = (float)-(A[k][0] * p[0] + A[k][1] * p[1] +
                                    A[k][2] * p[2]);
            }
        }
    });
}

}  // extern "C"
