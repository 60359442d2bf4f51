// Hand-written CUDA visit kernels of the binned cull+visit tracers
// (BinnedIntersector, SweepIntersector).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py), WITHOUT
// --use_fast_math.  The Moller-Trumbore test (mt.cuh) rounds after every
// operation, so the kernels equal their plain PyTorch versions bit for bit
// (kernels/binned.py: nearest_visits_reference, anyhit_visits_reference).
//
// Inputs:
//   pkt, sn, cmask, first, last (V,) i32: the flat visit list.  Visit v sends
//     packet pkt[v] against supernode sn[v]; bit k of cmask[v] gates cluster
//     k of the supernode.  A packet's visits are contiguous: its run starts
//     at a visit with first != 0 and ends at the next one with last != 0.
//     A packet has at most one run in a list.
//   o, d (P*128, 3), tmin (P*128,) [tmax (P*128,)] f32: rays, 128 per packet.
//   tri9 (S+1, 9, 8*128) f32: per-supernode triangle rows
//     [v0x v0y v0z e1x e1y e1z e2x e2y e2z], cluster-major columns; the last
//     supernode is the null one (zero triangles, never hit).
//   best_t (P*128,) f32 + best_code (P*128,) i32, or occ (P*128,) i32: read
//     at a run's start and written at its end, in place; packets with no run
//     in the list are not touched.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

#define BINNED_BP 128     // rays per packet = threads per block
#define BINNED_GROUP 8    // clusters per supernode
#define BINNED_C 128      // triangles per cluster

namespace {

// Stages cluster k of supernode s (9 rows of 128 floats) into shared memory.
__device__ __forceinline__ void stage_cluster(const float* tri9, int s, int k,
                                              float* s_tri) {
    const float* base = tri9 + (size_t)s * 9 * BINNED_GROUP * BINNED_C
                        + k * BINNED_C + threadIdx.x;
#pragma unroll
    for (int r = 0; r < 9; ++r)
        s_tri[r * BINNED_C + threadIdx.x] = base[r * BINNED_GROUP * BINNED_C];
}

// The body of both kernels below, which replace the Pallas kernels
// spray_tpu/kernels/binned.py `_nearest_kernel` (binned_nearest_kernel,
// OCC = false) and `_anyhit_kernel` (binned_anyhit_kernel, OCC = true).
// On the TPU the grid walks the visit list in order on one core and carries
// a packet's best (t, code) or occlusion in scratch from its `first` visit
// to its `last`; here blocks
// run in no order, so ONE BLOCK OWNS ONE RUN: the grid has a block per
// visit, a block whose visit does not start a run returns at once, and a
// block that starts one walks the run's visits in a loop, its 128 threads
// each carrying one ray's state in registers.
//
// nearest: per gated cluster, each thread tests its ray against the 128
//   triangles in row order with a strict t >= tmin && t < best, which
//   reproduces the reference's "lowest row among equal t, earliest cluster
//   and visit first"; code = (sn * 8 + k) * 128 + row.
// any-hit: tmin < t < win, win = 0 once occluded; an occluded thread skips
//   the arithmetic, and the block leaves the run when no thread is live.
//
// Bound on the H100: sum over visits of popcount(mask) x 128 x 128 tests of
// 46 fp32 operations over 67 TFLOP/s, against popcount x 4.6 KB of
// triangles plus one ray block per run over 3.35 TB/s: 128 rays share each
// staged triangle, so operations bound it.
// First, unoptimised design: as above; clusters are staged one at a time
// with two block barriers each, and a run's visits are serial in its block.
struct Visits {
    const int *pkt, *sn, *cmask, *first, *last;
    int n_visits;
};

struct Packets {
    const float *o, *d, *tmin, *tmax;  // tmax: any-hit only
    int n_packets;
};

template <bool OCC>
__device__ __forceinline__ void walk_run(const Visits& vs, const Packets& ry,
                                         const float* __restrict__ tri9,
                                         int n_super, float* best_t,
                                         int* best_code, int* occ_io,
                                         unsigned long long* tests) {
    const int *pkt = vs.pkt, *sn = vs.sn, *cmask = vs.cmask;
    const int *first = vs.first, *last = vs.last;
    const int n_visits = vs.n_visits, n_packets = ry.n_packets;
    const float *o = ry.o, *d = ry.d, *tmin = ry.tmin, *tmax = ry.tmax;
    __shared__ float s_tri[9 * BINNED_C];
    int v = blockIdx.x;
    if (first[v] == 0) return;  // the whole block: v is per block
    const int p = pkt[v];
    if (p < 0 || p >= n_packets) __trap();
    const int i = p * BINNED_BP + threadIdx.x;
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float lo = tmin[i];
    float cur = 0.f;
    int code = -1, occ = 0;
    unsigned long long done = 0;  // any-hit: ray-triangle tests of this lane
    if (OCC) {
        occ = occ_io[i];
        cur = tmax[i];  // the window's end while not occluded
    } else {
        cur = best_t[i];
        code = best_code[i];
    }
    for (; v < n_visits; ++v) {
        if (OCC && !__syncthreads_or(!occ && cur > lo)) break;
        const int mask = cmask[v];
        if (mask != 0) {
            const int s = sn[v];
            if (s < 0 || s >= n_super) __trap();
            for (int k = 0; k < BINNED_GROUP; ++k) {
                if (!(mask & (1 << k))) continue;
                __syncthreads();  // the previous cluster is no longer read
                stage_cluster(tri9, s, k, s_tri);
                __syncthreads();
                if (OCC) {
                    for (int j = 0; j < BINNED_C && !occ; ++j) {
                        const MtHit h = mt_test(s_tri + j, BINNED_C, ox, oy,
                                                oz, dx, dy, dz);
                        if (h.ok && h.t > lo && h.t < cur) occ = 1;
                        ++done;
                    }
                } else {
                    for (int j = 0; j < BINNED_C; ++j) {
                        const MtHit h = mt_test(s_tri + j, BINNED_C, ox, oy,
                                                oz, dx, dy, dz);
                        if (h.ok && h.t >= lo && h.t < cur) {
                            cur = h.t;
                            code = (s * BINNED_GROUP + k) * BINNED_C + j;
                        }
                    }
                }
            }
        }
        if (last[v] != 0) break;
    }
    if (OCC) {
        occ_io[i] = occ;
        if (tests != nullptr) atomicAdd(tests, done);
    } else {
        best_t[i] = cur;
        best_code[i] = code;
    }
}

__global__ void __launch_bounds__(BINNED_BP)
binned_nearest_kernel(Visits vs, Packets ry, const float* __restrict__ tri9,
                      int n_super, float* __restrict__ best_t,
                      int* __restrict__ best_code) {
    walk_run<false>(vs, ry, tri9, n_super, best_t, best_code, nullptr,
                    nullptr);
}

__global__ void __launch_bounds__(BINNED_BP)
binned_anyhit_kernel(Visits vs, Packets ry, const float* __restrict__ tri9,
                     int n_super, int* __restrict__ occ,
                     unsigned long long* __restrict__ tests) {
    walk_run<true>(vs, ry, tri9, n_super, nullptr, nullptr, occ, tests);
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// of the launch (0 = success).  n_super counts the rows of tri9 (S + 1).
// tests (any-hit): nullptr, or one u64 that receives the ray-triangle tests
// the launch did (an occluded lane stops testing).
int spray_binned_nearest(const int* pkt, const int* sn, const int* cmask,
                         const int* first, const int* last, int n_visits,
                         const float* o, const float* d, const float* tmin,
                         int n_packets, const float* tri9, int n_super,
                         float* best_t, int* best_code, void* stream) {
    const Visits vs = {pkt, sn, cmask, first, last, n_visits};
    const Packets ry = {o, d, tmin, nullptr, n_packets};
    binned_nearest_kernel<<<n_visits, BINNED_BP, 0, (cudaStream_t)stream>>>(
        vs, ry, tri9, n_super, best_t, best_code);
    return (int)cudaGetLastError();
}

int spray_binned_anyhit(const int* pkt, const int* sn, const int* cmask,
                        const int* first, const int* last, int n_visits,
                        const float* o, const float* d, const float* tmin,
                        const float* tmax, int n_packets, const float* tri9,
                        int n_super, int* occ, unsigned long long* tests,
                        void* stream) {
    const Visits vs = {pkt, sn, cmask, first, last, n_visits};
    const Packets ry = {o, d, tmin, tmax, n_packets};
    binned_anyhit_kernel<<<n_visits, BINNED_BP, 0, (cudaStream_t)stream>>>(
        vs, ry, tri9, n_super, occ, tests);
    return (int)cudaGetLastError();
}

}  // extern "C"
