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
// and those rays then hit a surface behind.  The slab test is (b - o) * inv,
// a subtraction then a product, which nothing can contract: its entry
// distance decides the visit order, the culls and with them the ties, so
// every kernel here uses that one expression.
//
// Page layout (one domain d of D, from build_cluster_domains):
//   bounds (D, Nn, 8, 6) f32  per child [lox, loy, loz, hix, hiy, hiz]
//   meta   (D, Nn, 8)    i32  >= 0 internal child node; -1 empty slot;
//                              <= -2 leaf, cluster id = -(m + 2)
//   w      (D, Nc, 4, 3C) f32  Woop transforms, column blocks [u | v | w]
// Rays are SoA in packet order: o, d (N, 3), tmin, tmax (N,), N = P * packet.
// order (P, R) i32 lists each packet's domains front to back, -1 ends it.
// A bucket map (P,) i32 instead names ONE page per packet, -1 = dead packet.
//
// Every kernel here gives each live ray one WARP (walk_domain_warp): lanes
// spread over a node's children and a leaf's triangles, the stack lies in
// shared memory, a block-level queue hands live rays to warps.

#include <cuda_runtime.h>
#include <stdint.h>

#define SPRAY_STACK 128        // traversal stack entries of one ray
#define SPRAY_BLOCK 256        // threads per block; a block takes 256 rays
#define SPRAY_WARPS (SPRAY_BLOCK / 32)
#define SPRAY_FULL 0xFFFFFFFFu
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

// x*a + y*b + z*c, rounded after every op like the plain version.
__device__ __forceinline__ float dot3_rn(float x, float y, float z, float a,
                                         float b, float c) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)),
                     __fmul_rn(z, c));
}

// The same against three rows of w, s floats apart.
__device__ __forceinline__ float dot3_rn(float x, float y, float z,
                                         const float* w, int s) {
    return dot3_rn(x, y, z, w[0], w[s], w[2 * s]);
}

// Woop test of the ray against row i of the cluster at W (4 x 3C floats).
// Returns whether the hit point lies inside the triangle; t is its distance
// (inf or NaN, and never taken, where the ray is parallel to the plane).
// All twelve loads come first and nothing branches before the end: with
// the loads behind the parallel-plane test the warp-per-ray kernels were a
// seventh slower on the H100.
__device__ __forceinline__ bool woop_test(const float* W, int c, int i,
                                          const Ray& r, float& t) {
    const int c3 = 3 * c;
    float a[4][3];  // rows of w, column blocks [u | v | w]
#pragma unroll
    for (int row = 0; row < 4; ++row)
#pragma unroll
        for (int blk = 0; blk < 3; ++blk)
            a[row][blk] = W[row * c3 + blk * c + i];
    const float ox = r.ox, oy = r.oy, oz = r.oz;
    const float dw = dot3_rn(r.dx, r.dy, r.dz, a[0][2], a[1][2], a[2][2]);
    const float ow = __fadd_rn(dot3_rn(ox, oy, oz, a[0][2], a[1][2], a[2][2]),
                               a[3][2]);
    t = __fdiv_rn(-ow, dw);
    const float ou = __fadd_rn(dot3_rn(ox, oy, oz, a[0][0], a[1][0], a[2][0]),
                               a[3][0]);
    const float du = dot3_rn(r.dx, r.dy, r.dz, a[0][0], a[1][0], a[2][0]);
    const float ov = __fadd_rn(dot3_rn(ox, oy, oz, a[0][1], a[1][1], a[2][1]),
                               a[3][1]);
    const float dv = dot3_rn(r.dx, r.dy, r.dz, a[0][1], a[1][1], a[2][1]);
    const float u = __fadd_rn(ou, __fmul_rn(t, du));
    const float v = __fadd_rn(ov, __fmul_rn(t, dv));
    return fabsf(dw) > 1e-20f && u >= 0.f && v >= 0.f
           && __fadd_rn(u, v) <= 1.f;
}

// The packed key of a nearest hit at distance t on row i: -0.0 would
// bit-cast to INT_MIN and hide every real hit, so t is clamped at +0.
__device__ __forceinline__ int hit_key(float t, int i) {
    const float tc = t > 0.f ? t : 0.f;
    return (__float_as_int(tc) & ~127) | i;
}

// A leaf's min key against the carried best: t rebuilt ROUNDED UP to the
// 128-ulp quantum, so windows only ever widen, never over-cull.
__device__ __forceinline__ void take_key(int kmin, int code0, float& best_t,
                                         int& best_code) {
    if (kmin == SPRAY_INF_KEY) return;
    const float t_up = __int_as_float((kmin & ~127) + 128);
    if (t_up < best_t) {
        best_t = t_up;
        best_code = code0 + (kmin & 127);
    }
}

// ------------------------------------------------------- warp per ray ----

// One warp walks one domain's 8-wide BVH for ONE ray.  The ray, best_t,
// best_code, the stack pointer and the counts are warp-uniform registers;
// the ordered stack (child meta, entry t) lies in shared memory.
//   internal node: lanes 0-7 slab-test one child each; a hit child's push
//     position is its rank among the hit children by (entry t, slot), which
//     is the order of a stable insertion sort; they are pushed in reverse,
//     so the nearest is on top (front-to-back visit order);
//   leaf: lane l tests rows l, l + 32, ... of the cluster's C, each row of w
//     read as coalesced 128-byte lines; nearest takes the warp's min key
//     (redux.sync), any-hit returns at the first stride with a hit.
// OCC = false: nearest hit; best_t / best_code carry the front-to-back
//   result across domains (t rounded UP to the 128-ulp key quantum).
// OCC = true: any hit in (tmin, best_t); returns true at the first one.
template <bool OCC>
__device__ __forceinline__ bool walk_domain_warp(
    const Pages& pg, int dom, const Ray& r, float& best_t, int& best_code,
    Counts& cnt, int* stk_m, float* stk_t, int lane) {
    const float inf = __int_as_float(0x7F800000);
    const int c = pg.c;
    const float* bounds = pg.bounds + (size_t)dom * pg.nn * 48;
    const int* meta = pg.meta + (size_t)dom * pg.nn * 8;
    const float* wdom = pg.w + (size_t)dom * pg.nc * 12 * c;

    __syncwarp();  // the previous walk's last pop is done in every lane
    if (lane == 0) {
        stk_m[0] = 0;  // the root node
        stk_t[0] = r.tmin;
    }
    int sp = 1;
    __syncwarp();

    while (sp > 0) {
        --sp;
        const int m = stk_m[sp];  // one address: a broadcast read
        if (stk_t[sp] > best_t) continue;  // culled by a nearer hit since
        if (m >= 0) {
            ++cnt.nodes;
            int mj = -1;
            float tj = inf;
            if (lane < 8) {
                // meta and bounds load together, not one after the other:
                // an empty / padded slot (-1) has bounds too, its test is
                // dropped
                const float2* p = reinterpret_cast<const float2*>(
                    bounds + (size_t)m * 48 + 6 * lane);
                mj = meta[(size_t)m * 8 + lane];
                const float2 b0 = p[0], b1 = p[1], b2 = p[2];
                const float b[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
                const float te = slab_entry(b, r, r.tmin, best_t);
                tj = mj != -1 ? te : inf;
            }
            const bool hit = tj < inf;
            const unsigned hits = __ballot_sync(SPRAY_FULL, hit);
            const int k = __popc(hits);
            int rank = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float ti = __shfl_sync(SPRAY_FULL, tj, i);
                if (((hits >> i) & 1u) && (ti < tj || (ti == tj && i < lane)))
                    ++rank;
            }
            // host checks 7*depth+1; one lane decides, k is warp-uniform
            if (lane == 0 && sp + k > SPRAY_STACK) __trap();
            __syncwarp();  // every lane has read the popped entry
            if (hit) {
                stk_m[sp + k - 1 - rank] = mj;
                stk_t[sp + k - 1 - rank] = tj;
            }
            sp += k;
            __syncwarp();  // the pushes are visible to the next pop
            continue;
        }
        // leaf: one cluster of C Woop-transformed triangles
        ++cnt.leaves;
        cnt.tests += c;
        const int cid = -(m + 2);
        const float* W = wdom + (size_t)cid * 12 * c;
        int kmin = SPRAY_INF_KEY;
        // not unrolled: 2 and 4 strides at once need more registers and
        // gained nothing on the H100
#pragma unroll 1
        for (int base = 0; base < c; base += 32) {
            const int i = base + lane;
            float t = 0.f;
            const bool in_uv = i < c && woop_test(W, c, i, r, t);
            if (OCC) {
                // occlusion gate is strict on both ends
                const bool h = in_uv && t > r.tmin && t < best_t;
                if (__any_sync(SPRAY_FULL, h)) return true;
            } else if (in_uv && t >= r.tmin && t < best_t) {
                kmin = min(kmin, hit_key(t, i));
            }
        }
        if (!OCC) {
            // keys are non-negative ints: the signed min is the key's min
            kmin = __reduce_min_sync(SPRAY_FULL, kmin);
            take_key(kmin, (dom * pg.nc + cid) * c, best_t, best_code);
        }
    }
    return false;
}

// What one block of the warp-per-ray kernels keeps in shared memory: the
// warps' stacks (8 KB) and the queue of the block's live rays.
struct WalkShared {
    int stk_m[SPRAY_WARPS][SPRAY_STACK];
    float stk_t[SPRAY_WARPS][SPRAY_STACK];
    int live_in_warp[SPRAY_WARPS];
    int cursor;
    unsigned char queue[SPRAY_BLOCK];  // live rays' offsets in the block
};

// Compacts the block's live rays into sh.queue in ray order (ballot and
// popc per warp, a prefix over the warps' counts) and returns their number.
// Every thread of the block calls it.
__device__ __forceinline__ int queue_live_rays(WalkShared& sh, bool live) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned b = __ballot_sync(SPRAY_FULL, live);
    if (lane == 0) sh.live_in_warp[warp] = __popc(b);
    if (threadIdx.x == 0) sh.cursor = 0;
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int j = 0; j < SPRAY_WARPS; ++j) {
        const int cj = sh.live_in_warp[j];
        if (j < warp) base += cj;
        total += cj;
    }
    if (live)
        sh.queue[base + __popc(b & ((1u << lane) - 1u))] =
            (unsigned char)threadIdx.x;
    __syncthreads();
    return total;
}

// The next live ray of the block for this warp (its offset in the block),
// or -1 when the queue is empty.
__device__ __forceinline__ int next_live_ray(WalkShared& sh, int total,
                                             int lane) {
    int q = 0;
    if (lane == 0) q = atomicAdd(&sh.cursor, 1);
    q = __shfl_sync(SPRAY_FULL, q, 0);
    return q < total ? (int)sh.queue[q] : -1;
}

// Once per warp, by lane 0.  A warp that walked no ray adds nothing: in a
// slot launch most warps find no live ray, and the atomics of all of them
// on the same three words made the traversal of a traced out-of-core frame
// ~15% slower on an H100.
__device__ __forceinline__ void flush_counts(unsigned long long* counters,
                                             const Counts& cnt) {
    if (counters == nullptr || (cnt.nodes | cnt.leaves | cnt.tests) == 0)
        return;
    atomicAdd(counters + 0, cnt.nodes);
    atomicAdd(counters + 1, cnt.leaves);
    atomicAdd(counters + 2, cnt.tests);
}

// The body of nearest_kernel (SLOT = false) and nearest_slot_kernel (SLOT =
// true).  A block takes 256 consecutive rays, compacts the live ones into a
// shared-memory queue, and its 8 warps pull rays from it until it is empty:
// work follows live rays, and a dead lane only stores.  Each ray walks its
// packet's list front to back: `order` holds n_rounds domains per packet,
// -1 ending a list.  With SLOT the list is one entry, the bucket map
// (P,) read as `order` with n_rounds the number of pages, and the contract
// is the slot's: a dead packet (bucket < 0) stores t 0 and code -1 on every
// lane, codes are domain-local (cluster * C + row).
template <bool SLOT>
__device__ __forceinline__ void nearest_rays(
    WalkShared& sh, const int* __restrict__ order, int n_rounds, int packet,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    const Pages& pg, float* __restrict__ out_t, int* __restrict__ out_code,
    unsigned long long* __restrict__ counters) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ray0 = blockIdx.x * SPRAY_BLOCK;
    const int mine = ray0 + threadIdx.x;
    const int width = SLOT ? 1 : n_rounds;  // list entries of a packet
    float hi = 0.f;
    bool dead_packet = false;
    if (mine < n) {
        hi = tmax[mine];
        if (SLOT) {
            const int dom = order[mine / packet];
            if (dom >= n_rounds) __trap();  // a bucket names a page the call lacks
            dead_packet = dom < 0;
        }
    }
    const bool live = hi > 0.f && !dead_packet;  // an empty window is a dead lane
    if (mine < n && !live) {
        out_t[mine] = dead_packet ? 0.f : hi;
        out_code[mine] = -1;
    }
    const int total = queue_live_rays(sh, live);
    Counts cnt = {0, 0, 0};
    for (int q; (q = next_live_ray(sh, total, lane)) >= 0;) {
        const int i = ray0 + q;
        const Ray r = load_ray(o, d, tmin, i);
        float best_t = tmax[i];
        int best_code = -1;
        const int* ord = order + (size_t)(i / packet) * width;
        for (int k = 0; k < width; ++k) {
            const int dom = ord[k];
            if (dom < 0) break;
            walk_domain_warp<false>(pg, dom, r, best_t, best_code, cnt,
                                    sh.stk_m[warp], sh.stk_t[warp], lane);
        }
        // the walk carries the global code (dom * Nc + cid) * C + row
        if (SLOT && best_code >= 0) best_code -= ord[0] * pg.nc * pg.c;
        if (lane == 0) {
            out_t[i] = best_t;
            out_code[i] = best_code;
        }
    }
    if (lane == 0) flush_counts(counters, cnt);
}

// Replaces the Pallas kernel spray_tpu/kernels/traverse.py
// `_nearest_fused_kernel` (all routed domain rounds of one intersect in one
// launch, best (t, global code) carried per ray).
// Bound on the H100: the FP32 arithmetic of the ray-triangle tests (about 40
// operations per test, a thousand tests and more per ray) over 67 TFLOP/s is
// far above the page bytes (~126 MB at the bench scene) over 3.35 TB/s, so
// the kernel is bound by operations.  What kept a thread-per-ray walk at a
// fortieth of that bound was divergence: the 32 rays of a warp sit at
// different nodes and leaves, a leaf is a serial loop of C tests, and the
// stack spills to local memory.
// Design: one warp walks one ray (walk_domain_warp, nearest_rays), so a
// warp never diverges and a leaf's C tests run 32 at a time on coalesced
// rows.
// 4 resident blocks per SM: 5 and more cap the registers and spill.
__global__ void __launch_bounds__(SPRAY_BLOCK, 4)
nearest_kernel(const int* __restrict__ order, int n_rounds, int packet,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               int n, Pages pg, float* __restrict__ out_t,
               int* __restrict__ out_code,
               unsigned long long* __restrict__ counters) {
    __shared__ WalkShared sh;
    nearest_rays<false>(sh, order, n_rounds, packet, o, d, tmin, tmax, n, pg,
                        out_t, out_code, counters);
}

// Replaces the Pallas kernel spray_tpu/kernels/traverse.py `_nearest_kernel`
// (`_nearest_body`): ONE domain per packet, chosen by the (P,) bucket map,
// as the out-of-core epoch slots, the per-round routed modes and the
// single-domain intersector launch it.  Its contract differs from
// nearest_kernel's in two ways, both the TPU kernel's own: the code is
// domain-local (cluster * C + row), and a dead packet (bucket < 0) writes
// t = 0 and code = -1 on every lane, where a live packet's lane without a
// hit keeps its tmax.
// Bound on the H100: as nearest_kernel, the FP32 arithmetic of the
// ray-triangle tests over 67 TFLOP/s; the slot's pages are read once per
// ray that reaches them, far fewer bytes than that work's operations.
// Design: nearest_kernel's warp walk over a one-entry list.  The epoch
// scheduler launches it over its whole padded wavefront, most packets
// sparse or dead: the block's queue of live rays keeps their lanes from
// costing a walk.
__global__ void __launch_bounds__(SPRAY_BLOCK, 4)
nearest_slot_kernel(const int* __restrict__ bucket, int n_dom, int packet,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, Pages pg,
                    float* __restrict__ out_t, int* __restrict__ out_code,
                    unsigned long long* __restrict__ counters) {
    __shared__ WalkShared sh;
    nearest_rays<true>(sh, bucket, n_dom, packet, o, d, tmin, tmax, n, pg,
                       out_t, out_code, counters);
}

// Replaces the Pallas kernels spray_tpu/kernels/traverse.py
// `_anyhit_fused_kernel` (full (P, R) lists: every round in one launch, the
// occlusion carried per ray) and `_anyhit_kernel` (`_anyhit_body`, one
// domain per packet per launch: one-entry lists).  A ray stops at its first
// hit; a ray occluded in an earlier round is never un-occluded, so the
// result equals the per-round grid form's.
// Bound on the H100: as nearest_kernel, FP32 operations of the ray-triangle
// tests over 67 TFLOP/s on full lists, with fewer tests per ray thanks to
// the early exit; on one-entry lists of sparse packets the page bytes.
// Design: as nearest_kernel, one warp per live ray from the block's queue,
// which is what keeps a packet with a handful of live lanes (the epoch
// scheduler's one-entry lists) from idling whole warps; a leaf ends at the
// first 32-row stride in which any lane hits.
__global__ void __launch_bounds__(SPRAY_BLOCK, 4)
anyhit_kernel(const int* __restrict__ order, int n_rounds, int packet,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmin, const float* __restrict__ tmax,
              int n, Pages pg, int* __restrict__ out_occ,
              unsigned long long* __restrict__ counters) {
    __shared__ WalkShared sh;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ray0 = blockIdx.x * SPRAY_BLOCK;
    const int mine = ray0 + threadIdx.x;
    const bool live = mine < n && tmax[mine] > 0.f;
    if (mine < n && !live) out_occ[mine] = 0;
    const int total = queue_live_rays(sh, live);
    Counts cnt = {0, 0, 0};
    for (int q; (q = next_live_ray(sh, total, lane)) >= 0;) {
        const int i = ray0 + q;
        const Ray r = load_ray(o, d, tmin, i);
        float hi = tmax[i];
        int unused = -1;
        bool occ = false;
        const int* ord = order + (size_t)(i / packet) * n_rounds;
        for (int k = 0; k < n_rounds && !occ; ++k) {
            const int dom = ord[k];
            if (dom < 0) break;
            occ = walk_domain_warp<true>(pg, dom, r, hi, unused, cnt,
                                         sh.stk_m[warp], sh.stk_t[warp], lane);
        }
        if (lane == 0) out_occ[i] = occ ? 1 : 0;
    }
    if (lane == 0) flush_counts(counters, cnt);
}

}  // namespace

extern "C" {

int spray_stack_size() { return SPRAY_STACK; }

// Blocks of SPRAY_BLOCK threads that one SM keeps resident for kernel
// `which` (0 nearest_kernel, 1 anyhit_kernel, 2 nearest_slot_kernel), by
// its registers and shared memory; -1 on an error.
int spray_blocks_per_sm(int which) {
    int blocks = -1;
    const void* fn = which == 0   ? (const void*)nearest_kernel
                     : which == 1 ? (const void*)anyhit_kernel
                                  : (const void*)nearest_slot_kernel;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, SPRAY_BLOCK,
                                                      0) != cudaSuccess)
        return -1;
    return blocks;
}

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
