// Hand-written CUDA router of the in-situ epoch loop: each round's send
// layout, the slot of every ray among those bound for the same owner rank.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py).
//
// Replaces no TPU kernel.  The reference routes with plain tensor code
// (spray_tpu/dist/epochs.py: `jnp.cumsum` of the one-hot owner over the
// rays, axis 0), and so did the port until this kernel: on the H100,
// torch.cumsum over dim 0 of an (m, ndev) tensor runs as
// tensor_kernel_scan_outer_dim, one thread a column walking its m rows one
// dependent load after another: ~41 ms a round at m = 262,144, ndev 4.
//
// Contract (kernels/route.py: route_slots_reference is the plain version):
//   dest (m,) int64   each ray's owner rank; a value outside [0, ndev)
//                     (the loop passes ndev) is "no destination"
//   send (ndev * bucket,) int64, written in full: slot owner * bucket + k
//                     holds the lane of the k-th ray, in lane order, whose
//                     dest is that owner, or m where fewer than k + 1 rays
//                     go there; rays past the bucket's size are not sent.
//
// Bound on the H100: bytes.  The rays' owners are read (8 m bytes) and the
// slots written (8 ndev bucket bytes) once: ~4 MB a round at m = 262,144,
// ndev 4, bucket 65,536, ~1.25 us at 3.35 TB/s; the work is a few integer
// operations a ray.
//
// Design: two launches over the same partition of the rays into chunks of
// ROUTE_THREADS lanes, at most ROUTE_MAX_BLOCKS blocks, each block taking a
// run of consecutive chunks.  route_count_kernel counts each owner's rays of
// each block into a (blocks, ndev) table.  route_slots_kernel then gives each
// block its owners' counts over the earlier blocks (one warp an owner, the
// table is in L2), and each ray its rank: that prefix, plus its owner's rays
// in the earlier warps of its chunk (per-warp counts in shared memory), plus
// those in the earlier lanes of its warp (popc of its __match_any_sync mask
// below the lane).  Every rank is a sum of counts, so the layout is the
// same on every run: no atomic decides an order (the counting kernel's
// shared-memory atomics only add).  The same kernel writes m into the empty
// slots (each owner's slots from its total count on, spread over the grid),
// so every slot is written exactly once and no fill precedes the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROUTE_THREADS 1024    // lanes of a chunk: one block's threads
#define ROUTE_WARPS (ROUTE_THREADS / 32)
#define ROUTE_MAX_BLOCKS 256  // rows of the count table (kernels/route.py)
#define ROUTE_MAX_NDEV 64     // owners the shared-memory tables hold

namespace {

struct Partition {
    int chunks;            // chunks of ROUTE_THREADS rays
    int chunks_per_block;  // consecutive chunks a block takes
    int blocks;
};

Partition partition(int m) {
    Partition p;
    p.chunks = (m + ROUTE_THREADS - 1) / ROUTE_THREADS;
    p.chunks_per_block = (p.chunks + ROUTE_MAX_BLOCKS - 1) / ROUTE_MAX_BLOCKS;
    p.blocks = (p.chunks + p.chunks_per_block - 1) / p.chunks_per_block;
    return p;
}

// This thread's ray of chunk c: its owner, or ndev for none (a lane past m
// included).
__device__ __forceinline__ int owner_of(const long long* dest, int m, int ndev,
                                        int c) {
    const long long i = (long long)c * ROUTE_THREADS + threadIdx.x;
    if (i >= m) return ndev;
    const long long v = dest[i];
    return (v >= 0 && v < ndev) ? (int)v : ndev;
}

// Each owner's rays in this block's chunks, into row blockIdx.x of table.
__global__ void __launch_bounds__(ROUTE_THREADS)
route_count_kernel(const long long* __restrict__ dest, int m, int ndev,
                   int chunks, int chunks_per_block, int* __restrict__ table) {
    __shared__ int s_count[ROUTE_MAX_NDEV];
    for (int o = threadIdx.x; o < ndev; o += ROUTE_THREADS) s_count[o] = 0;
    __syncthreads();
    const int first = blockIdx.x * chunks_per_block;
    const int last = min(first + chunks_per_block, chunks);
    for (int c = first; c < last; ++c) {
        const int d = owner_of(dest, m, ndev, c);
        const unsigned same = __match_any_sync(0xFFFFFFFFu, d);
        const int lane = threadIdx.x & 31;
        // the lowest lane of each owner adds its warp's rays
        if (d < ndev && (same & ((1u << lane) - 1u)) == 0)
            atomicAdd(&s_count[d], __popc(same));
    }
    __syncthreads();
    for (int o = threadIdx.x; o < ndev; o += ROUTE_THREADS)
        table[blockIdx.x * ndev + o] = s_count[o];
}

// Writes every slot of send: the rank of each ray that fits its owner's
// bucket, m in the rest.
__global__ void __launch_bounds__(ROUTE_THREADS)
route_slots_kernel(const long long* __restrict__ dest, int m, int ndev,
                   int bucket, int chunks, int chunks_per_block, int blocks,
                   const int* __restrict__ table,
                   long long* __restrict__ send) {
    __shared__ int s_warp[ROUTE_WARPS][ROUTE_MAX_NDEV];  // a chunk's counts
    __shared__ int s_base[ROUTE_MAX_NDEV];   // rays before the chunk
    __shared__ int s_total[ROUTE_MAX_NDEV];  // rays of every block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // each owner's rays in the earlier blocks, and in all of them
    for (int o = warp; o < ndev; o += ROUTE_WARPS) {
        int before = 0, total = 0;
        for (int k = lane; k < blocks; k += 32) {
            const int n = table[k * ndev + o];
            total += n;
            before += k < (int)blockIdx.x ? n : 0;
        }
        before = __reduce_add_sync(0xFFFFFFFFu, before);
        total = __reduce_add_sync(0xFFFFFFFFu, total);
        if (lane == 0) {
            s_base[o] = before;
            s_total[o] = total;
        }
    }
    __syncthreads();

    // the empty slots: k >= the owner's total, spread over the grid
    const long long slots = (long long)ndev * bucket;
    for (long long s = (long long)blockIdx.x * ROUTE_THREADS + threadIdx.x;
         s < slots; s += (long long)gridDim.x * ROUTE_THREADS) {
        const int o = (int)(s / bucket);
        if (s - (long long)o * bucket >= s_total[o]) send[s] = m;
    }

    const int first = blockIdx.x * chunks_per_block;
    const int last = min(first + chunks_per_block, chunks);
    for (int c = first; c < last; ++c) {
        const int d = owner_of(dest, m, ndev, c);
        const unsigned same = __match_any_sync(0xFFFFFFFFu, d);
        const int below = __popc(same & ((1u << lane) - 1u));
        for (int o = lane; o < ndev; o += 32) s_warp[warp][o] = 0;
        __syncwarp();
        if (d < ndev && below == 0) s_warp[warp][d] = __popc(same);
        __syncthreads();
        if (d < ndev) {
            int r = s_base[d] + below;
            for (int w = 0; w < warp; ++w) r += s_warp[w][d];
            if (r < bucket)
                send[(long long)d * bucket + r] =
                    (long long)c * ROUTE_THREADS + threadIdx.x;
        }
        __syncthreads();
        // the next chunk starts after this one's rays
        for (int o = threadIdx.x; o < ndev; o += ROUTE_THREADS) {
            int n = 0;
            for (int w = 0; w < ROUTE_WARPS; ++w) n += s_warp[w][o];
            s_base[o] += n;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

// The launcher runs both kernels on the caller's stream and returns
// cudaGetLastError() after each launch (0 = success).
// table: a (ROUTE_MAX_BLOCKS, ndev) int32 scratch; send: (ndev * bucket,).
int spray_route_slots(const long long* dest, int m, int ndev, int bucket,
                      int* table, long long* send, void* stream) {
    if (m < 1 || ndev < 1 || ndev > ROUTE_MAX_NDEV || bucket < 1)
        return (int)cudaErrorInvalidValue;
    const Partition p = partition(m);
    cudaStream_t st = (cudaStream_t)stream;
    route_count_kernel<<<p.blocks, ROUTE_THREADS, 0, st>>>(
        dest, m, ndev, p.chunks, p.chunks_per_block, table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    route_slots_kernel<<<p.blocks, ROUTE_THREADS, 0, st>>>(
        dest, m, ndev, bucket, p.chunks, p.chunks_per_block, p.blocks, table,
        send);
    return (int)cudaGetLastError();
}

}  // extern "C"
