// Hand-written CUDA Threefry-2x32 RNG of the wavefront integrators: from
// each ray's counter (pixel, sample, dim) to float32 uniforms, K dims a call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see spray_tpu_torch/kernels/_build.py).
//
// Replaces no TPU kernel: the reference draws with plain jnp code
// (spray_tpu/core/rng.py: threefry2x32 on uint32 arrays, fused by XLA).
//
// Contract (core/rng.py: random_bits and uniform are the plain version):
//   pixel  (n,) int64     flat pixel ids; the low 32 bits are the counter
//   sample (n,) int64     sample ids, or NULL and `sample_scalar` for all
//   seed                  the key's first word (the second is 0x3443F9A5)
//   dims   k of 1..4      counter dims
//   out    (k, n) float32 row j: (b0 >> 8) * 2^-24 of counter
//                         x0 = pixel, x1 = (sample << 16) | dims[j]
//
// Bound on the H100: bytes, instruction dispatch close behind.  A ray's
// counters are read once (16 bytes, 8 with a scalar sample) and its k
// uniforms written once (4 k bytes): ~117 MB for k = 3 at 4,194,304 rays,
// ~35 us at 3.35 TB/s.  A dim is ~77 integer operations (2 key adds; 20
// rounds of add, funnel shift, xor; 5 key injections of 2 adds; the
// counter's shift and or; the uniform's shift, convert, multiply): ~0.97 G
// for the same call, ~29 us at the dispatch rate of 4 warp instructions
// a clock an SM (integer adds go to the FMA pipe as well as the integer
// one).  chip_smoke.py phase 11 times it against both.
//
// Design: one thread a ray, grid-stride, no shared memory, no atomics.  The
// counters are read once and the k dims computed in registers on native
// uint32 words (rotate-left is one funnel shift); each row is written
// coalesced.  The uniform is exact in float32 (an integer below 2^24 times a
// power of two), so it equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define RNG_THREADS 256
#define RNG_MAX_BLOCKS 8192  // grid-stride beyond this many blocks
#define RNG_MAX_DIMS 4       // core/rng.py MAX_DIMS

namespace {

struct Dims {
    uint32_t d[RNG_MAX_DIMS];
};

// First output word of 20-round Threefry-2x32 under key (k0, k1), with
// k2 = k0 ^ k1 ^ 0x1BD11BDA, exactly as core/rng.py threefry2x32.
__device__ __forceinline__ uint32_t threefry_b0(uint32_t x0, uint32_t x1,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t k2) {
#define RNG_ROUND(r)                       \
    x0 += x1;                              \
    x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define RNG_ROUNDS_A RNG_ROUND(13) RNG_ROUND(15) RNG_ROUND(26) RNG_ROUND(6)
#define RNG_ROUNDS_B RNG_ROUND(17) RNG_ROUND(29) RNG_ROUND(16) RNG_ROUND(24)
    x0 += k0;
    x1 += k1;
    RNG_ROUNDS_A x0 += k1; x1 += k2 + 1u;
    RNG_ROUNDS_B x0 += k2; x1 += k0 + 2u;
    RNG_ROUNDS_A x0 += k0; x1 += k1 + 3u;
    RNG_ROUNDS_B x0 += k1; x1 += k2 + 4u;
    RNG_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef RNG_ROUNDS_B
#undef RNG_ROUNDS_A
#undef RNG_ROUND
    return x0;
}

__global__ void __launch_bounds__(RNG_THREADS)
threefry_uniform_kernel(const long long* __restrict__ pixel,
                        const long long* __restrict__ sample,
                        uint32_t sample_scalar, uint32_t seed, Dims dims,
                        int k, long long n, float* __restrict__ out) {
    const uint32_t k0 = seed, k1 = 0x3443F9A5u, k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    for (long long i = (long long)blockIdx.x * RNG_THREADS + threadIdx.x;
         i < n; i += (long long)gridDim.x * RNG_THREADS) {
        const uint32_t x0 = (uint32_t)pixel[i];
        const uint32_t s = sample ? (uint32_t)sample[i] : sample_scalar;
#pragma unroll
        for (int j = 0; j < RNG_MAX_DIMS; ++j) {
            if (j < k) {
                const uint32_t b0 =
                    threefry_b0(x0, (s << 16) | dims.d[j], k0, k1, k2);
                out[j * n + i] =
                    __fmul_rn(__uint2float_rn(b0 >> 8), 5.9604644775390625e-8f);
            }
        }
    }
}

}  // namespace

extern "C" {

// Launches the kernel on the caller's stream and returns cudaGetLastError()
// (0 = success).  sample is NULL for one sample id (sample_scalar) for all
// rays; d0..d3 are the dims, of which the first k are drawn.
int spray_threefry_uniform(const long long* pixel, const long long* sample,
                           uint32_t sample_scalar, uint32_t seed, uint32_t d0,
                           uint32_t d1, uint32_t d2, uint32_t d3, int k,
                           long long n, float* out, void* stream) {
    if (n < 1 || k < 1 || k > RNG_MAX_DIMS) return (int)cudaErrorInvalidValue;
    const Dims dims = {{d0, d1, d2, d3}};
    long long blocks = (n + RNG_THREADS - 1) / RNG_THREADS;
    if (blocks > RNG_MAX_BLOCKS) blocks = RNG_MAX_BLOCKS;
    threefry_uniform_kernel<<<(int)blocks, RNG_THREADS, 0,
                              (cudaStream_t)stream>>>(
        pixel, sample, sample_scalar, seed, dims, k, n, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
