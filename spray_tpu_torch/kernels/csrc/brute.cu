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
//   o, d (N, 3) f32, tmin, tmax (N,) f32
// The triangle loop runs in row order with a strict t < best, so the lowest
// row wins an exact tie.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

#define BRUTE_BLOCK 256  // threads (rays) per block
#define BRUTE_TILE 256   // triangles staged in shared memory per step

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
// Bound on the H100: rays x T tests of 46 fp32 operations each over
// 67 TFLOP/s; the table (T x 40 B) and the rays (48 B in and out each) are
// read and written once, far fewer bytes than that work: bound by
// operations.
// First, unoptimised design: one thread per ray, 256 rays per block; the
// block stages the table through shared memory 256 triangles at a time and
// every thread walks the tile in row order (all threads read the same
// shared address: a broadcast).  A dead lane (tmax <= tmin) takes the same
// path and falls out of the gate, so it returns t = tmax, prim = -1,
// u = v = 0 like every other miss.
__global__ void __launch_bounds__(BRUTE_BLOCK)
brute_nearest_kernel(const float* __restrict__ tri9,
                     const int* __restrict__ ids, int num_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n,
                     float* __restrict__ out_t, int* __restrict__ out_prim,
                     float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float s_tri[BRUTE_TILE * 9];
    __shared__ int s_ids[BRUTE_TILE];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    const int r = in_range ? i : 0;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float lo = tmin[r];
    float bt = tmax[r], bu = 0.f, bv = 0.f;
    int bp = -1;
    for (int t0 = 0; t0 < num_tris; t0 += BRUTE_TILE) {
        __syncthreads();  // the previous tile is no longer read
        stage_tile(tri9, ids, t0, num_tris, s_tri, s_ids);
        __syncthreads();
        const int count = min(BRUTE_TILE, num_tris - t0);
        for (int j = 0; j < count; ++j) {
            const MtHit h = mt_test(s_tri + 9 * j, 1, ox, oy, oz, dx, dy, dz);
            if (h.ok && h.t >= lo && h.t < bt && s_ids[j] >= 0) {
                bt = h.t;
                bp = s_ids[j];
                bu = h.u;
                bv = h.v;
            }
        }
    }
    if (in_range) {
        out_t[i] = bt;
        out_prim[i] = bp;
        out_u[i] = bu;
        out_v[i] = bv;
    }
}

// Replaces the Pallas kernel spray_tpu/kernels/brute.py `_anyhit_kernel`:
// occlusion, any triangle with tmin < t < tmax (strict on both ends).
// Bound on the H100: as brute_nearest_kernel, rays x T tests over
// 67 TFLOP/s (operations); a ray stops testing once it is occluded, which
// the bound of a run counts from that run's data.
// First, unoptimised design: as brute_nearest_kernel; an occluded thread
// skips the arithmetic but keeps staging tiles with its block.
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
int spray_brute_nearest(const float* tri9, const int* ids, int num_tris,
                        const float* o, const float* d, const float* tmin,
                        const float* tmax, int n, float* out_t, int* out_prim,
                        float* out_u, float* out_v, void* stream) {
    const int blocks = (n + BRUTE_BLOCK - 1) / BRUTE_BLOCK;
    brute_nearest_kernel<<<blocks, BRUTE_BLOCK, 0, (cudaStream_t)stream>>>(
        tri9, ids, num_tris, o, d, tmin, tmax, n, out_t, out_prim, out_u,
        out_v);
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
