// Hand-written CUDA traversal kernels of the multi-domain cluster BVH.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py), WITHOUT
// --use_fast_math: that flag flushes denormals and approximates division,
// which would break the t-key contract below.  nvcc contracts a*b+c into FMA
// by default; the ray-triangle test therefore spells its arithmetic with the
// _rn intrinsics, which are never contracted, so t, u and v round after every
// op exactly as in the plain PyTorch versions (kernels/traverse.py).  With
// FMA, the one-ulp differences in u and v decided a few grazing rays at a
// triangle edge differently (the per-triangle Woop test is not watertight),
// and those rays then hit a surface behind.  The slab tests keep FMA: the
// plain versions have no BVH to match.
//
// Page layout (one domain d of D, from build_cluster_domains):
//   bounds (D, Nn, 8, 6) f32  per child [lox, loy, loz, hix, hiy, hiz]
//   meta   (D, Nn, 8)    i32  >= 0 internal child node; -1 empty slot;
//                              <= -2 leaf, cluster id = -(m + 2)
//   w      (D, Nc, 4, 3C) f32  Woop transforms, column blocks [u | v | w]
// Rays are SoA in packet order: o, d (N, 3), tmin, tmax (N,), N = P * packet.
// order (P, R) i32 lists each packet's domains front to back, -1 ends it.
// A bucket map (P,) i32 instead names ONE page per packet, -1 = dead packet.

#include <cuda_runtime.h>
#include <stdint.h>

#define SPRAY_STACK 128        // per-thread traversal stack entries
#define SPRAY_BLOCK 256        // threads per block (one packet of 256 rays)
#define SPRAY_INF_KEY 0x7F800000

namespace {

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

struct Pages {
    const float* bounds;
    const int* meta;
    const float* w;
    int nn, nc, c;
};

struct Counts {
    unsigned long long nodes, leaves, tests;
};

// The slab rule of the TPU kernel: inv = 1 / (|d| > 1e-12 ? d : 1e-12),
// including its sign quirk (a tiny negative component becomes +1e-12).
__device__ __forceinline__ float safe_inv(float x) {
    return 1.0f / (fabsf(x) > 1e-12f ? x : 1e-12f);
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tmin, int i) {
    Ray r;
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
    r.tmin = tmin[i];
    return r;
}

// Slab test of one child box against the window [lo, hi]; returns the entry
// distance, or +inf when the box is missed.
__device__ __forceinline__ float slab_entry(const float* b, const Ray& r,
                                            float lo, float hi) {
    float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
    float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
    float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), lo));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fminf(fmaxf(t0z, t1z), hi));
    return tn <= tf ? tn : __int_as_float(0x7F800000);
}

// x*w[0] + y*w[s] + z*w[2s], rounded after every op like the plain version.
__device__ __forceinline__ float dot3_rn(float x, float y, float z,
                                         const float* w, int s) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, w[0]), __fmul_rn(y, w[s])),
                     __fmul_rn(z, w[2 * s]));
}

// Walks one domain's 8-wide BVH for one ray with a per-thread ordered stack.
// OCC = false: nearest hit; best_t / best_code carry the front-to-back
//   result across domains (t rounded UP to the 128-ulp key quantum).
// OCC = true: any hit in (tmin, best_t); returns true at the first one.
template <bool OCC>
__device__ bool traverse_domain(const Pages& pg, int dom, const Ray& r,
                                float& best_t, int& best_code, Counts& cnt) {
    const int c3 = 3 * pg.c;
    const float* bounds = pg.bounds + (size_t)dom * pg.nn * 48;
    const int* meta = pg.meta + (size_t)dom * pg.nn * 8;
    const float* wdom = pg.w + (size_t)dom * pg.nc * 4 * c3;

    int stk_m[SPRAY_STACK];
    float stk_t[SPRAY_STACK];
    int sp = 0;
    stk_m[sp] = 0;  // the root node
    stk_t[sp] = r.tmin;
    ++sp;

    while (sp > 0) {
        --sp;
        const int m = stk_m[sp];
        if (stk_t[sp] > best_t) continue;  // culled by a nearer hit since
        if (m >= 0) {
            // internal node: slab-test its 8 children, push the hit ones
            // so the nearest is on top (front-to-back visit order)
            ++cnt.nodes;
            float ct[8];
            int cm[8];
            int k = 0;
            const float* nb = bounds + (size_t)m * 48;
            const int* nm = meta + (size_t)m * 8;
            for (int j = 0; j < 8; ++j) {
                const int mj = nm[j];
                if (mj == -1) continue;  // empty / padded slot
                const float te = slab_entry(nb + 6 * j, r, r.tmin, best_t);
                if (!(te < __int_as_float(0x7F800000))) continue;
                // insertion sort by entry t (stable: ties keep slot order)
                int q = k++;
                while (q > 0 && ct[q - 1] > te) {
                    ct[q] = ct[q - 1];
                    cm[q] = cm[q - 1];
                    --q;
                }
                ct[q] = te;
                cm[q] = mj;
            }
            if (sp + k > SPRAY_STACK) __trap();  // host checks 7*depth+1
            for (int q = k - 1; q >= 0; --q) {
                stk_m[sp] = cm[q];
                stk_t[sp] = ct[q];
                ++sp;
            }
            continue;
        }
        // leaf: one cluster of C Woop-transformed triangles
        ++cnt.leaves;
        const int cid = -(m + 2);
        const float* W = wdom + (size_t)cid * 4 * c3;
        int kmin = SPRAY_INF_KEY;
        cnt.tests += pg.c;
        for (int i = 0; i < pg.c; ++i) {
            const float* wu = W + i;
            const float* wv = W + pg.c + i;
            const float* ww = W + 2 * pg.c + i;
            const float dw = dot3_rn(r.dx, r.dy, r.dz, ww, c3);
            if (!(fabsf(dw) > 1e-20f)) continue;
            const float ow = __fadd_rn(dot3_rn(r.ox, r.oy, r.oz, ww, c3), ww[3 * c3]);
            const float t = __fdiv_rn(-ow, dw);
            const float ou = __fadd_rn(dot3_rn(r.ox, r.oy, r.oz, wu, c3), wu[3 * c3]);
            const float du = dot3_rn(r.dx, r.dy, r.dz, wu, c3);
            const float ov = __fadd_rn(dot3_rn(r.ox, r.oy, r.oz, wv, c3), wv[3 * c3]);
            const float dv = dot3_rn(r.dx, r.dy, r.dz, wv, c3);
            const float u = __fadd_rn(ou, __fmul_rn(t, du));
            const float v = __fadd_rn(ov, __fmul_rn(t, dv));
            const bool in_uv = u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f;
            if (OCC) {
                // occlusion gate is strict on both ends
                if (in_uv && t > r.tmin && t < best_t) return true;
            } else if (in_uv && t >= r.tmin && t < best_t) {
                // -0.0 would bit-cast to INT_MIN and hide every real hit
                const float tc = t > 0.f ? t : 0.f;
                const int key = (__float_as_int(tc) & ~127) | i;
                kmin = min(kmin, key);
            }
        }
        if (!OCC && kmin != SPRAY_INF_KEY) {
            // t rebuilt ROUNDED UP: windows only ever widen, never over-cull
            const float t_up = __int_as_float((kmin & ~127) + 128);
            if (t_up < best_t) {
                best_t = t_up;
                best_code = (dom * pg.nc + cid) * pg.c + (kmin & 127);
            }
        }
    }
    return false;
}

__device__ __forceinline__ void flush_counts(unsigned long long* counters,
                                             const Counts& cnt) {
    if (counters == nullptr) return;
    atomicAdd(counters + 0, cnt.nodes);
    atomicAdd(counters + 1, cnt.leaves);
    atomicAdd(counters + 2, cnt.tests);
}

// Replaces the Pallas kernel spray_tpu/kernels/traverse.py
// `_nearest_fused_kernel` (all routed domain rounds of one intersect in one
// launch, best (t, global code) carried per ray).
// Bound on the H100: the FP32 arithmetic of the ray-triangle tests (about 38
// operations per test, thousands of tests per ray) over 67 TFLOP/s is far
// above the page bytes (~126 MB at the bench scene) over 3.35 TB/s, so the
// kernel is bound by operations, and in practice by divergence: threads of
// one warp walk different nodes.
// First, unoptimised design: one thread per ray, one block per packet of
// 256 rays in the live-partition order, each thread loops over its packet's
// domain list and walks each domain's BVH with a private stack; pages are
// read straight from global memory.  Later work: pages in shared memory,
// warp-per-packet traversal.
__global__ void __launch_bounds__(SPRAY_BLOCK)
nearest_kernel(const int* __restrict__ order, int n_rounds, int packet,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               int n, Pages pg, float* __restrict__ out_t,
               int* __restrict__ out_code,
               unsigned long long* __restrict__ counters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float best_t = tmax[i];
    int best_code = -1;
    Counts cnt = {0, 0, 0};
    if (best_t > 0.f) {  // an empty window (dead lane) returns at once
        const Ray r = load_ray(o, d, tmin, i);
        const int* ord = order + (size_t)(i / packet) * n_rounds;
        for (int k = 0; k < n_rounds; ++k) {
            const int dom = ord[k];
            if (dom < 0) break;
            traverse_domain<false>(pg, dom, r, best_t, best_code, cnt);
        }
    }
    out_t[i] = best_t;
    out_code[i] = best_code;
    flush_counts(counters, cnt);
}

// Replaces the Pallas kernel spray_tpu/kernels/traverse.py `_anyhit_kernel`
// (`_anyhit_body`), which the TPU path launches once per domain round; here
// one launch covers every round, and a ray stops at its first hit (a ray
// occluded in an earlier round is never un-occluded, so the result equals
// the per-round grid form's).
// Bound on the H100: as nearest_kernel, FP32 operations of the ray-triangle
// tests over 67 TFLOP/s, with fewer tests per ray thanks to the early exit.
// First, unoptimised design: one thread per ray, same traversal as above.
__global__ void __launch_bounds__(SPRAY_BLOCK)
anyhit_kernel(const int* __restrict__ order, int n_rounds, int packet,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmin, const float* __restrict__ tmax,
              int n, Pages pg, int* __restrict__ out_occ,
              unsigned long long* __restrict__ counters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float hi = tmax[i];
    int occ = 0;
    int unused = -1;
    Counts cnt = {0, 0, 0};
    if (hi > 0.f) {
        const Ray r = load_ray(o, d, tmin, i);
        const int* ord = order + (size_t)(i / packet) * n_rounds;
        for (int k = 0; k < n_rounds && !occ; ++k) {
            const int dom = ord[k];
            if (dom < 0) break;
            occ = traverse_domain<true>(pg, dom, r, hi, unused, cnt) ? 1 : 0;
        }
    }
    out_occ[i] = occ;
    flush_counts(counters, cnt);
}

// Replaces the Pallas kernel spray_tpu/kernels/traverse.py `_nearest_kernel`
// (`_nearest_body`): ONE domain per packet, chosen by the (P,) bucket map,
// as the out-of-core epoch slots and the single-domain intersector launch
// it.  Its contract differs from nearest_kernel's in two ways, both the TPU
// kernel's own: the code is domain-local (cluster * C + row), and a dead
// packet (bucket < 0) writes t = 0 and code = -1 on every lane, where a
// live packet's lane without a hit keeps its tmax.
// Bound on the H100: as nearest_kernel, the FP32 arithmetic of the
// ray-triangle tests over 67 TFLOP/s; the slot's pages are read once per
// ray that reaches them, far fewer bytes than that work's operations.
// First, unoptimised design: one thread per ray, the same per-thread
// traversal as nearest_kernel; a dead packet's threads only store.
__global__ void __launch_bounds__(SPRAY_BLOCK)
nearest_slot_kernel(const int* __restrict__ bucket, int n_dom, int packet,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, Pages pg,
                    float* __restrict__ out_t, int* __restrict__ out_code,
                    unsigned long long* __restrict__ counters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int dom = bucket[i / packet];
    if (dom < 0) {  // dead packet
        out_t[i] = 0.f;
        out_code[i] = -1;
        return;
    }
    if (dom >= n_dom) __trap();  // a bucket names a page the call lacks
    float best_t = tmax[i];
    int best_code = -1;
    Counts cnt = {0, 0, 0};
    if (best_t > 0.f) {
        const Ray r = load_ray(o, d, tmin, i);
        traverse_domain<false>(pg, dom, r, best_t, best_code, cnt);
    }
    out_t[i] = best_t;
    // traverse_domain carries the global code (dom * Nc + cid) * C + row
    out_code[i] = best_code >= 0 ? best_code - dom * pg.nc * pg.c : -1;
    flush_counts(counters, cnt);
}

}  // namespace

extern "C" {

int spray_stack_size() { return SPRAY_STACK; }

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// of the launch (0 = success).  counters: nullptr, or 3 x u64 that receive
// (node visits, leaf visits, ray-triangle tests).
int spray_nearest(const int* order, int n_rounds, int packet, const float* o,
                  const float* d, const float* tmin, const float* tmax, int n,
                  const float* bounds, const int* meta, const float* w,
                  int nn, int nc, int c, float* out_t, int* out_code,
                  unsigned long long* counters, void* stream) {
    Pages pg = {bounds, meta, w, nn, nc, c};
    const int blocks = (n + SPRAY_BLOCK - 1) / SPRAY_BLOCK;
    nearest_kernel<<<blocks, SPRAY_BLOCK, 0, (cudaStream_t)stream>>>(
        order, n_rounds, packet, o, d, tmin, tmax, n, pg, out_t, out_code,
        counters);
    return (int)cudaGetLastError();
}

int spray_anyhit(const int* order, int n_rounds, int packet, const float* o,
                 const float* d, const float* tmin, const float* tmax, int n,
                 const float* bounds, const int* meta, const float* w,
                 int nn, int nc, int c, int* out_occ,
                 unsigned long long* counters, void* stream) {
    Pages pg = {bounds, meta, w, nn, nc, c};
    const int blocks = (n + SPRAY_BLOCK - 1) / SPRAY_BLOCK;
    anyhit_kernel<<<blocks, SPRAY_BLOCK, 0, (cudaStream_t)stream>>>(
        order, n_rounds, packet, o, d, tmin, tmax, n, pg, out_occ, counters);
    return (int)cudaGetLastError();
}

// bucket (P,) i32: the page index of each packet, -1 for a dead packet;
// n_dom: the number of pages (D) behind bounds / meta / w.
int spray_nearest_slot(const int* bucket, int n_dom, int packet,
                       const float* o, const float* d, const float* tmin,
                       const float* tmax, int n, const float* bounds,
                       const int* meta, const float* w, int nn, int nc, int c,
                       float* out_t, int* out_code,
                       unsigned long long* counters, void* stream) {
    Pages pg = {bounds, meta, w, nn, nc, c};
    const int blocks = (n + SPRAY_BLOCK - 1) / SPRAY_BLOCK;
    nearest_slot_kernel<<<blocks, SPRAY_BLOCK, 0, (cudaStream_t)stream>>>(
        bucket, n_dom, packet, o, d, tmin, tmax, n, pg, out_t, out_code,
        counters);
    return (int)cudaGetLastError();
}

}  // extern "C"
