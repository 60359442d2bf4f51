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
//   best_t (P*128,) f32 + best_code (P*128,) i32, or occ (P*128,) i32: a
//     run's input, overwritten in place with its result; packets with no
//     run in the list are not touched.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

#define BINNED_BP 128     // rays per packet = threads per block
#define BINNED_GROUP 8    // clusters per supernode
#define BINNED_C 128      // triangles per cluster
#define BINNED_SPAN 2     // visits one block of binned_nearest_kernel walks
#define BINNED_ANYHIT_SPAN 1  // visits one block of binned_anyhit_kernel walks
#define BINNED_NO_KEY 0xFFFFFFFFFFFFFFFFull  // a ray with no hit yet

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

// On the TPU the grid walks the visit list in order on one core and carries
// a packet's best (t, code) or occlusion in scratch from its `first` visit
// to its `last`; here blocks run in no order, so each kernel below says
// how a run's carry is kept.
struct Visits {
    const int *pkt, *sn, *cmask, *first, *last;
    int n_visits;
};

struct Packets {
    const float *o, *d, *tmin, *tmax;  // tmax: any-hit only
    int n_packets;
};

// The first visit of the run that is open when visit a is reached, or -1:
// the nearest visit before a that carries a flag opens a run there, unless
// it closes one.  The block reads 4 x BINNED_BP visits' flags a step.
__device__ int open_run(const Visits& vs, int a, int* s_near) {
    for (int hi = a; hi > 0; hi -= 4 * BINNED_BP) {
        if (threadIdx.x == 0) *s_near = -1;
        __syncthreads();
        int near = -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int u = hi - 1 - threadIdx.x - j * BINNED_BP;
            if (u >= 0 && (vs.first[u] | vs.last[u]) != 0 && u > near) near = u;
        }
        if (near >= 0) atomicMax(s_near, near);
        __syncthreads();
        const int f = *s_near;
        __syncthreads();  // read by all before the next step resets it
        if (f >= 0) return vs.last[f] != 0 ? -1 : f;
    }
    return -1;
}

// t's bits as an unsigned key that orders like t, -0.0 taken as +0.0: the
// two compare equal, so between them the earlier visit must win.
__device__ __forceinline__ unsigned order_bits(float t) {
    const unsigned u = __float_as_uint(t == 0.f ? 0.f : t);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Replaces the Pallas kernel spray_tpu/kernels/binned.py `_nearest_kernel`.
// Per gated cluster, each thread tests its ray against the 128 triangles in
// row order with a strict t >= tmin && t < best; the reference keeps the
// lowest row among equal t, then the earliest cluster, then the earliest
// visit; code = (sn * 8 + k) * 128 + row.
// Bound on the H100: sum over visits of popcount(mask) x 128 x 128 tests of
// 46 fp32 operations over 67 TFLOP/s, against popcount x 4.6 KB of
// triangles plus one ray block per run over 3.35 TB/s: 128 rays share each
// staged triangle, so operations bound it.
// Design: a block walks a SPAN of BINNED_SPAN consecutive visits, not a
// whole run, so a run of thousands of visits (the sweep's later chunks)
// spreads over many blocks.  Its 128 threads carry one ray each, serially
// over the visits of each run segment in the span, from the run's input
// best_t (the window); at a segment's end a ray that took a hit merges the
// 64-bit key (order_bits(t), visit << 10 | cluster << 7 | row) into `keys`
// with atomicMin, which keeps the reference's order across blocks.
// binned_nearest_finish then writes each ray's t and code once: one small
// launch a call, simpler than finishing in a run's last block (no arrival
// counter, no fence).  Clusters are staged one at a time with two block
// barriers each.  Of the spans 32, 16, 8, 4, 2 and 1 timed on the H100, 1
// and 2 were the fastest on both the sweep and the binned cascade: the more
// blocks, the better the card balances visits that gate 0 to 8 clusters.
__global__ void __launch_bounds__(BINNED_BP)
binned_nearest_kernel(Visits vs, Packets ry, const float* __restrict__ tri9,
                      int n_super, const float* __restrict__ win_t,
                      unsigned long long* __restrict__ keys) {
    __shared__ float s_tri[9 * BINNED_C];
    __shared__ int s_near;
    const int a = blockIdx.x * BINNED_SPAN;
    const int end = min(a + BINNED_SPAN, vs.n_visits);
    // block-uniform: the first visit of the run being walked, or -1
    int run = vs.first[a] != 0 ? -1 : open_run(vs, a, &s_near);
    int i = 0;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float lo = 0.f, win = 0.f, cur = 0.f;
    unsigned where = 0;  // visit << 10 | cluster << 7 | row of cur
    auto begin = [&](int p) {
        if (p < 0 || p >= ry.n_packets) __trap();
        i = p * BINNED_BP + threadIdx.x;
        ox = ry.o[3 * i]; oy = ry.o[3 * i + 1]; oz = ry.o[3 * i + 2];
        dx = ry.d[3 * i]; dy = ry.d[3 * i + 1]; dz = ry.d[3 * i + 2];
        lo = ry.tmin[i];
        win = cur = win_t[i];
    };
    auto flush = [&]() {  // cur < win: this segment took a hit
        if (cur < win)
            atomicMin(keys + i,
                      ((unsigned long long)order_bits(cur) << 32) | where);
    };
    if (run >= 0) begin(vs.pkt[run]);
    for (int v = a; v < end; ++v) {
        if (vs.first[v] != 0) {
            if (run >= 0) flush();
            run = v;
            begin(vs.pkt[v]);
        }
        if (run < 0) continue;  // between a run's last visit and the next first
        const int mask = vs.cmask[v];
        if (mask != 0) {
            const int s = vs.sn[v];
            if (s < 0 || s >= n_super) __trap();
            for (int k = 0; k < BINNED_GROUP; ++k) {
                if (!(mask & (1 << k))) continue;
                __syncthreads();  // the previous cluster is no longer read
                stage_cluster(tri9, s, k, s_tri);
                __syncthreads();
                for (int j = 0; j < BINNED_C; ++j) {
                    const MtHit h = mt_test(s_tri + j, BINNED_C, ox, oy, oz,
                                            dx, dy, dz);
                    if (h.ok && h.t >= lo && h.t < cur) {
                        cur = h.t;
                        where = ((unsigned)v << 10) | (k << 7) | j;
                    }
                }
            }
        }
        if (vs.last[v] != 0) {
            flush();
            run = -1;
        }
    }
    if (run >= 0) flush();
}

// Writes each ray's merged best once: the code from its key, t recomputed
// with mt_test on the winning (visit, cluster, row), so a -0.0 hit keeps
// the sign the key cannot carry.  A ray with no key keeps its input.
__global__ void binned_nearest_finish(const int* __restrict__ sn,
                                      const float* __restrict__ o,
                                      const float* __restrict__ d,
                                      const float* __restrict__ tri9,
                                      const unsigned long long* __restrict__ keys,
                                      int n, float* __restrict__ best_t,
                                      int* __restrict__ best_code) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned long long key = keys[i];
    if (key == BINNED_NO_KEY) return;
    const unsigned where = (unsigned)key;
    const int v = where >> 10, k = (where >> 7) & 7, row = where & 127;
    const int s = sn[v];
    const MtHit h = mt_test(tri9 + (size_t)s * 9 * BINNED_GROUP * BINNED_C
                                + k * BINNED_C + row,
                            BINNED_GROUP * BINNED_C, o[3 * i], o[3 * i + 1],
                            o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    best_t[i] = h.t;
    best_code[i] = (s * BINNED_GROUP + k) * BINNED_C + row;
}

// Replaces the Pallas kernel spray_tpu/kernels/binned.py `_anyhit_kernel`:
// a hit is tmin < t < tmax on a lane not yet occluded.
// Bound on the H100: the tests that the serial order needs
// (kernels/binned.py anyhit_serial_tests: a lane occluded at input or with
// an empty window needs none, any other lane tests every row of every
// gated cluster of its run in (visit, cluster, row) order up to and
// including its first hit) of 46 fp32 operations over 67 TFLOP/s, against
// the staged clusters and one ray block per run over 3.35 TB/s.
// Design: runs are split as binned_nearest_kernel's are: a block walks a
// span of BINNED_ANYHIT_SPAN visits, finds the run open at its first visit
// with open_run and walks each run segment of the span, one lane per ray.
// The merge is an OR, so the blocks of a run share each ray's flag in
// occ_io itself, with no key and no finishing launch: before it stages a
// gated cluster a block re-reads its packet's flags (volatile: another
// block may have set them), a lane whose flag is 1 or whose window is empty
// tests nothing, and when no lane is left the block skips the rest of its
// run segment (__syncthreads_or); a lane that hits stores 1, the value
// every writer writes.  The blocks of a long run are dispatched roughly in
// index order, so later spans mostly start after earlier ones have set
// their flags: the serial design's early exit survives the split.  The
// tests counter counts the tests the blocks did, which depends on that
// order.  Clusters are staged one at a time with two barriers each; the
// test is mt_test_staged, which stops as soon as it must miss.  Of the
// spans 8, 4, 2 and 1 timed on the H100, 1 was the fastest on both the
// sweep and the binned cascade.
__global__ void __launch_bounds__(BINNED_BP)
binned_anyhit_kernel(Visits vs, Packets ry, const float* __restrict__ tri9,
                     int n_super, int* occ_io,
                     unsigned long long* __restrict__ tests) {
    __shared__ float s_tri[9 * BINNED_C];
    __shared__ int s_near;
    volatile int* flags = occ_io;
    const int a = blockIdx.x * BINNED_ANYHIT_SPAN;
    const int end = min(a + BINNED_ANYHIT_SPAN, vs.n_visits);
    // block-uniform: the first visit of the run being walked, or -1
    int run = vs.first[a] != 0 ? -1 : open_run(vs, a, &s_near);
    int i = 0;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float lo = 0.f, hi = 0.f;
    bool done = true;   // this lane has nothing left to test in its run
    bool spent = true;  // block-uniform: no lane of the run is left
    unsigned count = 0;  // ray-triangle tests of this lane
    auto begin = [&](int p) {
        if (p < 0 || p >= ry.n_packets) __trap();
        i = p * BINNED_BP + threadIdx.x;
        ox = ry.o[3 * i]; oy = ry.o[3 * i + 1]; oz = ry.o[3 * i + 2];
        dx = ry.d[3 * i]; dy = ry.d[3 * i + 1]; dz = ry.d[3 * i + 2];
        lo = ry.tmin[i];
        hi = ry.tmax[i];
        done = !(hi > lo);  // an empty window never hits
        spent = false;
    };
    if (run >= 0) begin(vs.pkt[run]);
    for (int v = a; v < end; ++v) {
        if (vs.first[v] != 0) {
            run = v;
            begin(vs.pkt[v]);
        }
        const int mask = run >= 0 && !spent ? vs.cmask[v] : 0;
        if (mask != 0) {
            const int s = vs.sn[v];
            if (s < 0 || s >= n_super) __trap();
            for (int k = 0; k < BINNED_GROUP; ++k) {
                if (!(mask & (1 << k))) continue;
                if (!done && flags[i] != 0) done = true;
                // also the barrier after which the previous cluster is no
                // longer read
                if (!__syncthreads_or(!done)) {
                    spent = true;
                    break;
                }
                stage_cluster(tri9, s, k, s_tri);
                __syncthreads();
                for (int j = 0; j < BINNED_C && !done; ++j) {
                    const float* r = s_tri + j;
                    ++count;
                    mt_test_staged(r[0], r[BINNED_C], r[2 * BINNED_C],
                                   r[3 * BINNED_C], r[4 * BINNED_C],
                                   r[5 * BINNED_C], r[6 * BINNED_C],
                                   r[7 * BINNED_C], r[8 * BINNED_C], ox, oy,
                                   oz, dx, dy, dz, [&](float t, float, float) {
                        if (t > lo && t < hi) {
                            done = true;
                            flags[i] = 1;
                        }
                    });
                }
            }
        }
        if (vs.last[v] != 0) run = -1;
    }
    if (tests != nullptr) {
        count = __reduce_add_sync(0xFFFFFFFFu, count);
        if ((threadIdx.x & 31) == 0 && count != 0)
            atomicAdd(tests, (unsigned long long)count);
    }
}

}  // namespace

extern "C" {

int spray_binned_span() { return BINNED_SPAN; }

int spray_binned_anyhit_span() { return BINNED_ANYHIT_SPAN; }

// Blocks of BINNED_BP threads that one SM keeps resident for
// binned_nearest_kernel, by its registers and shared memory; -1 on an error.
int spray_binned_blocks_per_sm() {
    int blocks = -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, binned_nearest_kernel, BINNED_BP, 0) != cudaSuccess)
        return -1;
    return blocks;
}

// Each launcher runs on the caller's stream and returns the first CUDA error
// of its calls (0 = success).  n_super counts the rows of tri9 (S + 1).
// nearest: best_t / best_code are the runs' input windows and receive the
// result; keys (P*128,) u64 is scratch the caller allocates (the launcher
// fills it with BINNED_NO_KEY).
int spray_binned_nearest(const int* pkt, const int* sn, const int* cmask,
                         const int* first, const int* last, int n_visits,
                         const float* o, const float* d, const float* tmin,
                         int n_packets, const float* tri9, int n_super,
                         float* best_t, int* best_code,
                         unsigned long long* keys, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (n_visits >= (1 << 22)) return (int)cudaErrorInvalidValue;  // key bits
    const Visits vs = {pkt, sn, cmask, first, last, n_visits};
    const Packets ry = {o, d, tmin, nullptr, n_packets};
    const int n = n_packets * BINNED_BP;
    const cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n * 8, st);
    if (err != cudaSuccess) return (int)err;
    binned_nearest_kernel<<<(n_visits + BINNED_SPAN - 1) / BINNED_SPAN,
                            BINNED_BP, 0, st>>>(vs, ry, tri9, n_super, best_t,
                                                keys);
    if (n > 0)
        binned_nearest_finish<<<(n + 255) / 256, 256, 0, st>>>(
            sn, o, d, tri9, keys, n, best_t, best_code);
    return (int)cudaGetLastError();
}

// occ: the runs' input flags, updated in place.  tests: nullptr, or one u64
// that receives the ray-triangle tests the launch did (a lane stops at its
// flag; how many it did depends on the order the blocks ran in).
int spray_binned_anyhit(const int* pkt, const int* sn, const int* cmask,
                        const int* first, const int* last, int n_visits,
                        const float* o, const float* d, const float* tmin,
                        const float* tmax, int n_packets, const float* tri9,
                        int n_super, int* occ, unsigned long long* tests,
                        void* stream) {
    const Visits vs = {pkt, sn, cmask, first, last, n_visits};
    const Packets ry = {o, d, tmin, tmax, n_packets};
    binned_anyhit_kernel<<<(n_visits + BINNED_ANYHIT_SPAN - 1)
                               / BINNED_ANYHIT_SPAN,
                           BINNED_BP, 0, (cudaStream_t)stream>>>(
        vs, ry, tri9, n_super, occ, tests);
    return (int)cudaGetLastError();
}

}  // extern "C"
