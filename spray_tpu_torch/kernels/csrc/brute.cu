// Hand-written CUDA brute-force kernels: every ray against every triangle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py), WITHOUT
// --use_fast_math.  The Moller-Trumbore test (mt.cuh) rounds after every
// operation, so the kernels equal their plain PyTorch versions bit for bit
// (kernels/brute.py: brute_nearest_reference, brute_anyhit_reference).
//
// Inputs:
//   tri12 (T, 12) f32  the table packed as three 16-byte vectors a row,
//                      [v0x v0y v0z 0 | e1x e1y e1z 0 | e2x e2y e2z id]
//                      with the int32 bits of the row's id in the twelfth
//                      word (kernels/brute.py pack_table); the id is what a
//                      hit on the row reports, and a row with id < 0 never
//                      hits (padding)
//   o, d (N, 3) f32, tmin, tmax (N,) f32
// The triangle loop runs in row order with a strict t < best, so the lowest
// row wins an exact tie.
//
// Both kernels give a block BRUTE_THREADS consecutive rays.  A dead lane
// (!(tmax > tmin), NaN included) gets its miss values at once, and the live
// ones go to a queue in shared memory in ray order, one a thread from the
// first, so that a warp's rays are neighbours and whole warps of dead lanes
// do no work.  Each thread tests its ray against the staged rows with
// mt_test_staged, which stops a test as soon as it must miss: a warp of
// neighbouring rays mostly stops together, before the division.  The table
// is staged BRUTE_TILE rows at a time and read with three 16-byte loads a
// row (a broadcast: every thread reads the same address).  The row loop
// runs in every thread (nvcc keeps its counter and address in uniform
// registers); a row with id < 0 is skipped before its test.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

#define BRUTE_TILE 256     // triangles staged in shared memory per step
#define BRUTE_THREADS 128  // rays (threads) a block of either kernel

namespace {

// Queues the block's live rays in ray order, one a thread from the first
// (ballots and a prefix over the warps), and returns how many there are.
__device__ __forceinline__ int queue_live_rays(bool live, int i, int* s_queue,
                                               int* s_count) {
    constexpr int kWarps = BRUTE_THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;  // live rays of the warps before this one, all
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s_count[w] : 0;
        total += s_count[w];
    }
    if (live) s_queue[before + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    return total;
}

// Stages rows [t0, t0 + count) of the packed table into shared memory.
__device__ __forceinline__ void stage_rows(const float4* tri12, int t0,
                                           int count, float4* s_tri) {
    for (int j = threadIdx.x; j < 3 * count; j += BRUTE_THREADS)
        s_tri[j] = tri12[(size_t)3 * t0 + j];
}

// Replaces the Pallas kernel spray_tpu/kernels/brute.py `_nearest_kernel`
// (an (8, 128) ray tile against the whole triangle table in SMEM).
// Bound on the H100: live rays x T tests of 46 fp32 operations each over
// 67 TFLOP/s; the table (T x 40 B) and the rays (48 B in and out each) are
// read and written once, far fewer bytes than that work: bound by
// operations.  The test has no FMA (mt.cuh), and the peak counts an FMA as
// two operations, so a kernel that does every test in full reaches at most
// about half of the bound.
// Design (the file's head): a dead lane gets t = tmax, prim = -1,
// u = v = 0; a live ray keeps the first row with tmin <= t < best.  Tried
// on the H100 and dropped: 2 and 4 rays a thread (the triangle's loads
// shared across them) and __frcp_rn for the division.
__global__ void __launch_bounds__(BRUTE_THREADS)
brute_nearest_kernel(const float4* __restrict__ tri12, int num_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     float* __restrict__ out_t, int* __restrict__ out_prim,
                     float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float4 s_tri[3 * BRUTE_TILE];
    __shared__ int s_queue[BRUTE_THREADS];
    __shared__ int s_count[BRUTE_THREADS / 32];
    const int i = blockIdx.x * BRUTE_THREADS + threadIdx.x;
    bool live = false;
    if (i < n) {
        const float hi = tmax[i];
        live = hi > tmin[i];
        if (!live) {
            out_t[i] = hi;
            out_prim[i] = -1;
            out_u[i] = 0.f;
            out_v[i] = 0.f;
        }
    }
    const int total = queue_live_rays(live, i, s_queue, s_count);
    if (total == 0) return;  // the whole block
    // this thread's ray: queue entry threadIdx.x; a spare thread reads ray
    // 0 with a window of -inf (it never hits), and a warp of spare threads
    // skips the tests whole
    const bool mine = threadIdx.x < total;
    const int r = mine ? s_queue[threadIdx.x] : 0;
    const bool warp_has_rays = (threadIdx.x >> 5) * 32 < total;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float lo = tmin[r];
    float bt = mine ? tmax[r] : __int_as_float(0xFF800000), bu = 0.f, bv = 0.f;
    int bp = -1;
    for (int t0 = 0; t0 < num_tris; t0 += BRUTE_TILE) {
        const int count = min(BRUTE_TILE, num_tris - t0);
        __syncthreads();  // the previous tile is no longer read
        stage_rows(tri12, t0, count, s_tri);
        __syncthreads();
        for (int j = 0; j < count; ++j) {
            const float4 c = s_tri[3 * j + 2];
            const int id = __float_as_int(c.w);
            if (id < 0 || !warp_has_rays) continue;
            const float4 a = s_tri[3 * j], b = s_tri[3 * j + 1];
            mt_test_staged(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, ox, oy,
                           oz, dx, dy, dz, [&](float t, float u, float v) {
                if (t >= lo && t < bt) {
                    bt = t;
                    bp = id;
                    bu = u;
                    bv = v;
                }
            });
        }
    }
    if (mine) {
        out_t[r] = bt;
        out_prim[r] = bp;
        out_u[r] = bu;
        out_v[r] = bv;
    }
}

// Replaces the Pallas kernel spray_tpu/kernels/brute.py `_anyhit_kernel`:
// occlusion, any triangle with tmin < t < tmax (strict on both ends).
// Bound on the H100: the tests the serial order needs (kernels/brute.py
// anyhit_serial_tests: none on a dead lane, else every row with id >= 0
// up to and including the first that occludes the ray) of 46 fp32
// operations over 67 TFLOP/s (operations; the table and the rays are far
// fewer bytes).
// Design (the file's head), with the first hit ending a ray's work: a dead
// lane writes occ = 0 at once; a queued ray stops testing at its first
// hit, a warp whose rays are all occluded (spare threads count as
// occluded) leaves the row loop (__any_sync), and at every tile boundary
// the block leaves whole once none of its rays is unoccluded
// (__syncthreads_or, which is also the barrier before staging).  The gate
// sits in the hit handler.  Each ray tests exactly the rows the serial
// order needs, so the kernel's count equals the bound's.
// tests: nullptr, or one u64 that receives the ray-triangle tests begun.
__global__ void __launch_bounds__(BRUTE_THREADS)
brute_anyhit_kernel(const float4* __restrict__ tri12, int num_tris,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    int* __restrict__ out_occ,
                    unsigned long long* __restrict__ tests) {
    __shared__ float4 s_tri[3 * BRUTE_TILE];
    __shared__ int s_queue[BRUTE_THREADS];
    __shared__ int s_count[BRUTE_THREADS / 32];
    const int i = blockIdx.x * BRUTE_THREADS + threadIdx.x;
    bool live = false;
    if (i < n) {
        live = tmax[i] > tmin[i];
        if (!live) out_occ[i] = 0;
    }
    const int total = queue_live_rays(live, i, s_queue, s_count);
    if (total == 0) return;  // the whole block
    const bool mine = threadIdx.x < total;
    const int r = mine ? s_queue[threadIdx.x] : 0;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float lo = tmin[r], hi = tmax[r];
    bool occ = !mine;  // a spare thread has nothing to find
    unsigned long long done = 0;
    for (int t0 = 0; t0 < num_tris; t0 += BRUTE_TILE) {
        // the previous tile is no longer read; every ray occluded: done
        if (!__syncthreads_or(!occ)) break;
        const int count = min(BRUTE_TILE, num_tris - t0);
        stage_rows(tri12, t0, count, s_tri);
        __syncthreads();
        for (int j = 0; j < count; ++j) {
            if (!__any_sync(0xFFFFFFFFu, !occ)) break;  // the warp is done
            const float4 c = s_tri[3 * j + 2];
            if (__float_as_int(c.w) < 0 || occ) continue;
            const float4 a = s_tri[3 * j], b = s_tri[3 * j + 1];
            ++done;
            mt_test_staged(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, ox, oy,
                           oz, dx, dy, dz, [&](float t, float, float) {
                if (t > lo && t < hi) occ = true;
            });
        }
    }
    if (mine) out_occ[r] = occ;
    if (tests != nullptr) {  // one atomic a warp
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            done += __shfl_down_sync(0xFFFFFFFFu, done, k);
        if ((threadIdx.x & 31) == 0 && done) atomicAdd(tests, done);
    }
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// of the launch (0 = success).
// tri12: the packed table, 16-byte aligned.
int spray_brute_nearest(const float* tri12, int num_tris, const float* o,
                        const float* d, const float* tmin, const float* tmax,
                        int n, float* out_t, int* out_prim, float* out_u,
                        float* out_v, void* stream) {
    if ((uintptr_t)tri12 % 16 != 0) return (int)cudaErrorMisalignedAddress;
    const int blocks = (n + BRUTE_THREADS - 1) / BRUTE_THREADS;
    brute_nearest_kernel<<<blocks, BRUTE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)tri12, num_tris, o, d, tmin, tmax, n, out_t, out_prim,
        out_u, out_v);
    return (int)cudaGetLastError();
}

int spray_brute_anyhit(const float* tri12, int num_tris, const float* o,
                       const float* d, const float* tmin, const float* tmax,
                       int n, int* out_occ, unsigned long long* tests,
                       void* stream) {
    if ((uintptr_t)tri12 % 16 != 0) return (int)cudaErrorMisalignedAddress;
    const int blocks = (n + BRUTE_THREADS - 1) / BRUTE_THREADS;
    brute_anyhit_kernel<<<blocks, BRUTE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)tri12, num_tris, o, d, tmin, tmax, n, out_occ, tests);
    return (int)cudaGetLastError();
}

}  // extern "C"
