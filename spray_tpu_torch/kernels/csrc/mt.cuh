// Moller-Trumbore ray-triangle test shared by brute.cu and binned.cu, in
// full (mt_test) and staged (mt_test_staged: the same operations, stopping
// as soon as the test must miss).
//
// Spelled with the _rn intrinsics, which nvcc never contracts into FMA, so
// t, u and v round after every operation exactly as in the plain PyTorch
// versions (core/geom.moller_trumbore): with FMA, one-ulp differences in u
// and v decide grazing rays at a triangle edge differently.

#pragma once

#include <cuda_runtime.h>

#define SPRAY_MT_OPS 46  // arithmetic operations of one mt_test (counted below)

struct MtHit {
    float t, u, v;
    bool ok;
};

// One ray against one triangle whose 9 floats [v0 | e1 | e2] lie at
// tri[0], tri[stride], ..., tri[8 * stride].  The formula and operation order
// of core/geom.moller_trumbore: |det| > 1e-7, inv = 1 / det, products times
// inv (not divisions), u >= 0, v >= 0, u + v <= 1.
// Operations: pvec 9, det 5, inv 1, tvec 3, u 6, qvec 9, v 6, t 6, u+v 1.
__device__ __forceinline__ MtHit mt_test(const float* tri, int stride,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
    const float v0x = tri[0], v0y = tri[stride], v0z = tri[2 * stride];
    const float e1x = tri[3 * stride], e1y = tri[4 * stride];
    const float e1z = tri[5 * stride];
    const float e2x = tri[6 * stride], e2y = tri[7 * stride];
    const float e2z = tri[8 * stride];
    MtHit h;
    const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
    const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
    const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
    const float det = __fadd_rn(
        __fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)), __fmul_rn(e1z, pz));
    h.ok = fabsf(det) > 1e-7f;
    const float inv = __fdiv_rn(1.0f, h.ok ? det : 1.0f);
    const float tx = __fsub_rn(ox, v0x);
    const float ty = __fsub_rn(oy, v0y);
    const float tz = __fsub_rn(oz, v0z);
    h.u = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)),
                  __fmul_rn(tz, pz)), inv);
    const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
    const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
    const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
    h.v = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, qx), __fmul_rn(dy, qy)),
                  __fmul_rn(dz, qz)), inv);
    h.t = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                  __fmul_rn(e2z, qz)), inv);
    h.ok = h.ok && h.u >= 0.f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.f;
    return h;
}

// mt_test of the ray against the triangle (v0, e1, e2), operation for
// operation, stopping as soon as the test must miss, and calling
// on_hit(t, u, v) (mt_test's t, u and v bit for bit) where it hits: the
// caller's gate then runs only on hits (returning h and gating after the
// call, nvcc gated every test).  Every stop is exact:
//   - before the division, from un = tvec . pvec (u = un * inv): where un
//     and det have opposite signs and |un| >= |det| * 2^-100, u is negative
//     (|u| >= 2^-100 * (1 - 2^-24), far from rounding to -0.0); where they
//     share a sign and |un| >= 2 |det|, u > 1;
//   - u > 1 misses, since with v >= 0 the rounded u + v is at least u.
// A warp whose lanes' rays all stop at a stage skips the rest: rays and
// triangles far apart stop before the division.  Each stop is one
// predicate (`|`, not `||`, which nvcc may split into a branch a term).
template <class OnHit>
__device__ __forceinline__ void mt_test_staged(
        float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
        float e2x, float e2y, float e2z, float ox, float oy, float oz,
        float dx, float dy, float dz, OnHit&& on_hit) {
    const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
    const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
    const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
    const float det = __fadd_rn(
        __fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)), __fmul_rn(e1z, pz));
    const float tx = __fsub_rn(ox, v0x);
    const float ty = __fsub_rn(oy, v0y);
    const float tz = __fsub_rn(oz, v0z);
    const float un = __fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)),
                               __fmul_rn(tz, pz));
    const float ad = fabsf(det);
    const float q = det < 0.f ? -un : un;  // un * sign(det)
    if (!(ad > 1e-7f) | (q < -__fmul_rn(ad, 0x1p-100f))
        | (q >= __fmul_rn(2.f, ad)))
        return;
    const float inv = __fdiv_rn(1.0f, det);
    const float u = __fmul_rn(un, inv);
    if (!(u >= 0.f) | (u > 1.f)) return;
    const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
    const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
    const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
    const float v = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, qx), __fmul_rn(dy, qy)),
                  __fmul_rn(dz, qz)), inv);
    if (!(v >= 0.f) | !(__fadd_rn(u, v) <= 1.f)) return;
    on_hit(__fmul_rn(
               __fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                         __fmul_rn(e2z, qz)), inv),
           u, v);
}
