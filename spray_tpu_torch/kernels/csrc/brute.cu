// Hand-written CUDA brute-force kernels: every ray against every triangle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py), WITHOUT
// --use_fast_math.  The Moller-Trumbore test (mt.cuh) rounds after every
// operation, so the kernels equal their plain PyTorch versions bit for bit
// (kernels/brute.py: brute_nearest_reference, brute_anyhit_reference).
//
// Inputs:
//   tri9 (T, 9) f32  rows [v0x v0y v0z | e1x e1y e1z | e2x e2y e2z]
//   ids  (T,)   i32  the id a hit on row i reports; a row with id < 0 never
//                    hits (padding)
//   (brute_nearest_kernel takes both as tri12 (T, 12) f32: rows
//    [v0 0 | e1 0 | e2 id-bits], three 16-byte vectors)
//   o, d (N, 3) f32, tmin, tmax (N,) f32
// The triangle loop runs in row order with a strict t < best, so the lowest
// row wins an exact tie.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

#define BRUTE_BLOCK 256  // threads (rays) per block of brute_anyhit_kernel
#define BRUTE_TILE 256   // triangles staged in shared memory per step
#define BRUTE_NEAREST_THREADS 128  // rays (threads) a block of brute_nearest_kernel

namespace {

// Stages triangles [t0, t0 + BRUTE_TILE) of the table into shared memory.
__device__ __forceinline__ void stage_tile(const float* tri9, const int* ids,
                                           int t0, int num_tris, float* s_tri,
                                           int* s_ids) {
    const int count = min(BRUTE_TILE, num_tris - t0);
    for (int j = threadIdx.x; j < count * 9; j += blockDim.x)
        s_tri[j] = tri9[(size_t)t0 * 9 + j];
    for (int j = threadIdx.x; j < count; j += blockDim.x)
        s_ids[j] = ids[t0 + j];
}

// Replaces the Pallas kernel spray_tpu/kernels/brute.py `_nearest_kernel`
// (an (8, 128) ray tile against the whole triangle table in SMEM).
// Bound on the H100: live rays x T tests of 46 fp32 operations each over
// 67 TFLOP/s; the table (T x 40 B) and the rays (48 B in and out each) are
// read and written once, far fewer bytes than that work: bound by
// operations.  The test has no FMA (mt.cuh), and the peak counts an FMA as
// two operations, so a kernel that does every test in full reaches at most
// about half of the bound.
// Design: a block takes BRUTE_NEAREST_THREADS consecutive rays; a dead lane
// (tmax <= tmin) gets its miss values (t = tmax, prim = -1, u = v = 0) at
// once, and the live ones go to a queue in shared memory in ray order
// (ballots and a prefix over the warps), one per thread from the first,
// so that a warp's rays are neighbours and whole warps of dead lanes do no
// work.  Each thread tests its ray against the staged triangles with
// mt_test_staged, which stops a test as soon as it must miss: a warp of
// neighbouring rays mostly stops together, before the division.  The
// table comes packed as rows of 12 words, v0 | e1 | e2 with the id's bits
// in the twelfth (kernels/brute.py pack_table), staged 256 rows at a time
// and read with three 16-byte loads a row (a broadcast: every thread reads
// the same address).  The ray walks the rows in order with a strict
// t < best, so the lowest row wins an exact tie; a row with id < 0 is
// skipped.  Tried on the H100 and dropped: 2 and 4 rays a thread (the
// triangle's loads shared across them) and __frcp_rn for the division.
__global__ void __launch_bounds__(BRUTE_NEAREST_THREADS)
brute_nearest_kernel(const float4* __restrict__ tri12, int num_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     float* __restrict__ out_t, int* __restrict__ out_prim,
                     float* __restrict__ out_u, float* __restrict__ out_v) {
    constexpr int kWarps = BRUTE_NEAREST_THREADS / 32;
    __shared__ float4 s_tri[3 * BRUTE_TILE];
    __shared__ int s_queue[BRUTE_NEAREST_THREADS];
    __shared__ int s_count[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * BRUTE_NEAREST_THREADS + threadIdx.x;
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
    if (total == 0) return;  // the whole block
    // this thread's ray: queue entry threadIdx.x; a spare thread reads ray
    // 0 with a window of -inf (it never hits), and a warp of spare threads
    // skips the tests whole
    const bool mine = threadIdx.x < total;
    const int r = mine ? s_queue[threadIdx.x] : 0;
    const bool warp_has_rays = warp * 32 < total;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float lo = tmin[r];
    float bt = mine ? tmax[r] : __int_as_float(0xFF800000), bu = 0.f, bv = 0.f;
    int bp = -1;
    for (int t0 = 0; t0 < num_tris; t0 += BRUTE_TILE) {
        const int count = min(BRUTE_TILE, num_tris - t0);
        __syncthreads();  // the previous tile is no longer read
        for (int j = threadIdx.x; j < 3 * count; j += BRUTE_NEAREST_THREADS)
            s_tri[j] = tri12[(size_t)3 * t0 + j];
        __syncthreads();
        // the row loop runs in every thread (nvcc keeps its counter and
        // address in uniform registers); a warp without rays skips its body
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
// Bound on the H100: the tests the kernel counts (a ray stops testing once
// it is occluded) of 46 fp32 operations over 67 TFLOP/s (operations).
// First, unoptimised design: one thread per ray, 256 rays per block; the
// block stages the table through shared memory 256 triangles at a time and
// every thread walks the tile in row order (all threads read the same
// shared address: a broadcast); an occluded thread skips the arithmetic but
// keeps staging tiles with its block.
// tests: nullptr, or one u64 that receives the ray-triangle tests done.
__global__ void __launch_bounds__(BRUTE_BLOCK)
brute_anyhit_kernel(const float* __restrict__ tri9,
                    const int* __restrict__ ids, int num_tris,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    int* __restrict__ out_occ,
                    unsigned long long* __restrict__ tests) {
    __shared__ float s_tri[BRUTE_TILE * 9];
    __shared__ int s_ids[BRUTE_TILE];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    const int r = in_range ? i : 0;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float lo = tmin[r], hi = tmax[r];
    int occ = 0;
    unsigned long long done = 0;
    for (int t0 = 0; t0 < num_tris; t0 += BRUTE_TILE) {
        __syncthreads();
        stage_tile(tri9, ids, t0, num_tris, s_tri, s_ids);
        __syncthreads();
        const int count = min(BRUTE_TILE, num_tris - t0);
        for (int j = 0; j < count && !occ; ++j) {
            const MtHit h = mt_test(s_tri + 9 * j, 1, ox, oy, oz, dx, dy, dz);
            if (h.ok && h.t > lo && h.t < hi && s_ids[j] >= 0) occ = 1;
            ++done;
        }
    }
    if (in_range) {
        out_occ[i] = occ;
        if (tests != nullptr) atomicAdd(tests, done);
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
    const int blocks = (n + BRUTE_NEAREST_THREADS - 1) / BRUTE_NEAREST_THREADS;
    brute_nearest_kernel<<<blocks, BRUTE_NEAREST_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float4*)tri12, num_tris, o, d, tmin, tmax, n, out_t, out_prim,
        out_u, out_v);
    return (int)cudaGetLastError();
}

int spray_brute_anyhit(const float* tri9, const int* ids, int num_tris,
                       const float* o, const float* d, const float* tmin,
                       const float* tmax, int n, int* out_occ,
                       unsigned long long* tests, void* stream) {
    const int blocks = (n + BRUTE_BLOCK - 1) / BRUTE_BLOCK;
    brute_anyhit_kernel<<<blocks, BRUTE_BLOCK, 0, (cudaStream_t)stream>>>(
        tri9, ids, num_tris, o, d, tmin, tmax, n, out_occ, tests);
    return (int)cudaGetLastError();
}

}  // extern "C"
