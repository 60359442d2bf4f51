#!/usr/bin/env python3
"""Smoke run of spray_tpu_torch on one CUDA card: build, parity, main path.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check makes the run exit 1):
  1. the card's name and power limit; nvcc builds every kernel source of
     spray_tpu_torch/kernels/csrc into build/kernels/, one nvcc per source,
     and g++ the native host library (spray_tpu_torch/native) into
     build/native/, all started together; each kernel's registers, shared memory, stack and
     spills from nvcc's report, and the resident blocks per SM of the three
     traversal kernels (warp-per-ray walks, none may spill) and of the
     split nearest visit kernel, and the visits a block of each visit kernel
     walks;
  2. kernel parity: each CUDA kernel against its plain PyTorch version and
     the torch brute oracle, on a 40,962-tri wisp scene (6 domains, 41
     supernodes), 16,384 random rays plus the bounce-1 and shadow wavefronts
     of a small render, dead lanes and dead packets included: the traversal
     kernels through the multi-domain intersector, the slot kernel through
     ClusterBVHIntersector, the brute kernels through
     PallasBruteIntersector, the visit kernels on the visit lists of real
     BinnedIntersector and SweepIntersector calls (kept by a recording
     proxy); the brute and visit kernels equal their plain versions bit
     for bit; the two nearest entry points, which share one warp walk,
     against each other on one-entry domain lists cut from those calls
     (nearest_kernel == nearest_slot_kernel: t bit-equal, code equal after
     the domain offset with no tie tolerance, the three counts equal), and
     every traversal kernel == the host's BVH-following walk_reference on
     WALK_PACKETS packets, full lists and one-entry lists, counts included;
     a constructed visit launch (a supernode and its copy in one run of
     more than 4 spans of the split kernel) == the plain version bit for
     bit; BVHIntersector (a BVH walk in batched torch ops, no kernel of
     its own) against the brute kernels and the jnp out-of-core backend
     against the cluster backend on the same waves, with the wall time of
     each, and default_intersector's "auto" choice on the card;
  3. path parity: a 64x64 PT+NEE frame through the kernels == the same frame
     through the plain versions (the PlainIntersector proxy), on the card,
     and so are the loss and gradients of a 64x64 training step; the frame
     through every `routed` mode is byte-identical to the default's, and
     through prefer="binned", "sweep" and PallasBruteIntersector equal to
     it within the same tolerance;
  4. the forward path at full size: make_pipeline(backward=False) on
     wisp_cloud(n_blobs=8, tris_per_blob=131072, seed=3) (2,621,442 tris,
     21 domains), 512x512, spp 4, bounces 2, PT+NEE, seed 0: frame time,
     rays traced, Grays/s, peak memory, launch counts, per-kernel time
     against its bound, and each kernel against its plain version on a
     sample of SAMPLE_PACKETS live packets of every main-path call; on that
     sample the two nearest entry points against each other and every
     kernel against walk_reference as in phase 2;
  5. the speculative epoch scheduler at full size: the same scene and
     camera at spp 1, host-driven render_device through OOCIntersector in
     the reference's two scheduler configurations (8 domains in 8 slots:
     speculate True, 3, False; 64 domains through 8 slots: lookahead on and
     off), each through bench_torch.suite_row (the suite's own loop):
     frame time and scheduler counters of each; the five images
     byte-identical and close to the forward path's; the slot kernel and
     the any-hit kernel (one-entry domain lists) timed over every call of
     one config-4 frame against their bounds, and held against their plain
     versions on sampled calls of that frame, the slot kernel also against
     walk_reference (counts included);
  6. the training step at full size: make_pipeline(backward=True) on the
     bench configuration of phase 4: step time, Grays/s fwd+bwd, peak
     memory, loss and gradient norms;
  7. the alternate intersectors at full width, ALT_TIMED timed frames each:
     the phase-4 frame through default_intersector(prefer="sweep") and
     prefer="binned" (frame time, Grays/s, peak memory, visits, rounds or
     chunks and host syncs per frame, every visit launch of one frame timed
     against its bound (the any-hit's counts the tests the serial order
     needs, binned.anyhit_serial_tests, and the tests its blocks did are
     printed beside it), per trace call the runs per launch, the longest and
     median run and the blocks launched (one per span of visits), sampled
     runs of sampled launches of every trace call (the longest among them,
     cut to their first VISIT_SAMPLE_LEN visits, so that runs cross blocks
     in both kernels) held against the plain versions, the image against
     phase 4's); constructed launches of the split any-hit kernel (a hit
     only in a long run's last span or only in its first, packets occluded
     at input, visits between a run's last and the next first) against the
     plain version; constructed launches of the brute any-hit kernel
     (every ray of two blocks occluded by row 0, a hit only in the last
     tile, every lane dead, rows with id < 0 between the hits) bit for
     bit, with the expected flags and its own test count == the serial
     order's;
     the same frame through routed="grid" (byte-identical image; the slot
     and one-entry any-hit kernels over every call of one frame against
     their bounds, sampled calls against the plain versions and the slot
     kernel against walk_reference) and the fused any-hit against the
     per-round form on the frame's two shadow wavefronts (equal occlusion,
     times of both); PallasBruteIntersector
     at 512x512, spp 4, bounces 2 on cornell_box() and on phase 2's wisp
     scene (frame time, the live lanes of every brute launch of one frame,
     each launch against its bound (the any-hit's counts the tests the
     serial order needs, brute.anyhit_serial_tests, and the tests the
     kernel began must equal it), sampled ray blocks against the plain
     versions, the image against the default intersector's);
  8. the distributed paths (spray_tpu_torch.dist) in a world of one rank
     started by run_world, through NCCL: (a) make_sharded_render_grad at
     phase 6's configuration with default_intersector, its loss and
     gradients against phase 6's (step time, all_reduce count, launches);
     (b) make_insitu_renderer on the same scene and camera at spp 1, 8
     domains, one bucket holding the rank's rays, against the fast path's
     frame through the 8-domain multi-domain intersector (max abs diff
     1e-4; both frame times and their ratio, last_stats, host syncs,
     launches of the slot and any-hit kernels); (c) tests_tpu/insitu_gate.py's
     configuration (131,074 tris, 128x128) at its bucket and at one that
     overflows, both against the fast path, and make_insitu_diff_fn's loss
     and gradients against make_diff_render_fn's; (d) every per-page call
     of one in-situ frame timed against its bound, and sampled calls held
     against the plain versions, the slot kernel also against
     walk_reference;
  9. the host layers and entry points: (a) the native library loaded (a
     missing one fails the run), the bench scene's pages built with it and
     with the numpy fallback, each timed, both equal to phase 4's bit for
     bit, and phase 4's rays_traced beside BENCH_r05.json's (a record);
     (b) the CLI in this process (spray_tpu_torch.cli.main): render
     --builtin wisp at its defaults (512x512, spp 16, bounces 3), then the
     ooc and baseline schedulers at 256x256, spp 1, 16 domains in 4 slots
     (byte-identical images, epochs > 0), and inspect; (c) fit on phase 2's
     wisp scene at 128x128 through the card's default_intersector,
     FIT_STEPS steps (the loss falls at every step), the same steps with
     fit(device="cpu") on the same inputs (each loss within FIT_RTOL), and
     the card's run cut at a checkpoint and resumed (the losses bit-equal); (d) InteractiveViewer, two frames
     and an orbit at 64x64; (e) bench_torch.py --iters 2 --suite as its own
     process (exit 0, one JSON line, rays_per_frame == phase 6's), and
     the build/BENCH_extra_torch.json it writes: bench.py's five suite rows
     and profiling/scaling_curve.py's curve rows with exactly their keys,
     committed equal in the three config-3 rows, no speculation in
     config3_baseline, 0 < speculation efficiency <= 1, config4_prefetch's
     lookahead open (probe above 50 MB/s), the slot and any-hit kernels
     launched in every row, positive curve times; each row's counters
     printed beside BENCH_extra.json's; (f)
     tests_gpu/parity_gate.py as its own process (exit 0); (g)
     tests_gpu/insitu_gate.py as its own process (exit 0: the in-situ
     frame within 1e-4 and 3x of the fast path's, and route_slots_kernel
     equal to its plain version, one launch a round);
 10. the form of the frame, which make_render_fn chooses from the card's
     free memory, on the phase-4 frame (512x512, spp 4) through the
     default intersector: (a) with the card's free memory it takes the
     batched form (peak within RAY_BYTES a ray); (b) with a ballast tensor
     leaving half of what the batched wavefront needs, the per-sample
     form, one wavefront a sample: frame time, peak memory and launches of
     each, the images within 1e-6 and rays_traced equal; (c) one
     per-sample frame's calls of nearest_kernel and anyhit_kernel timed
     against their bounds, the last sample's held against the plain
     versions and walk_reference as in phase 4;
 11. the Threefry kernel (threefry_uniform_kernel) on the main path: the
     phase-4 frame batched at the offline cell's spp 16, bounces 3 and at
     spp 4, bounces 2: 1 + 2 x bounces launches a frame, the image
     byte-equal to the same frame drawn by the plain int64 version on the
     card's tensors, the allocator's peak of both (requested bytes and the
     blocks that hold them); at spp 16 every draw site of the frame, on
     the frame's own pixel and sample tensors, bit-equal to the plain
     version and timed against its bound (integer operations or bytes) and
     the plain version, and one draw with one sample id for all rays.
Each path's launch counts are set to 0 just before it runs and read just
after (phase 9's subprocesses count their own).  The line before the last
is the kernels JSON (eight kernels); the
last line is {"ok": true, "device": {...}}.  Needs torch with CUDA and
nvcc; imports nothing of JAX.
"""

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
TEST_OPS = 40  # arithmetic of one ray-triangle test (see traverse.cu)
NODE_OPS = 8 * 22  # slab tests of one 8-wide node visit
SAMPLE_PACKETS = 256  # live packets of each main-path call held against plain
WALK_PACKETS = 1  # packets of a call that the host's walk_reference follows
WARP_PER_RAY = ("nearest_kernel", "anyhit_kernel", "nearest_slot_kernel")
MT_OPS = 46  # arithmetic of one Möller–Trumbore test (csrc/mt.cuh)
ALT_TIMED = 2  # timed frames of each alternate-intersector path, after a warm-up
VISIT_SAMPLE_LAUNCHES = 3  # visit launches of each trace call held against plain
VISIT_SAMPLE_RUNS = 32  # runs of each of those launches
VISIT_SAMPLE_LEN = 48  # visits kept of each sampled run (the plain version
# walks a run's visits one rank at a time: a sweep run can hold thousands)
BRUTE_SAMPLE_BLOCKS = 32  # 256-ray blocks of each brute call held against plain
TIE_PIXELS = 10000  # one pixel in this many may differ between hit-test formulas
RNG_DIM_OPS = 77  # integer operations of one Threefry dim (see csrc/rng.cu)
DISPATCH_S = 33.4e12  # H100 SXM dispatch: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
RNG_REPS = 50  # timed launches of each recorded draw site
SLEEP_CYCLES = 40_000_000  # a sleep kernel's cycles, ~20 ms: the queue it holds
FAILED = []


_T0 = [time.perf_counter()]


def phase_done(name):
    """Print the seconds since the previous call (the phase's wall time)."""
    now = time.perf_counter()
    print(f"{name} took {now - _T0[0]:.1f} s", flush=True)
    _T0[0] = now


def check(name, ok, detail=""):
    print(f"check {'PASS' if ok else 'FAIL'} {name} {detail}".rstrip(), flush=True)
    if not ok:
        FAILED.append(name)


def rand_rays(torch, scene, n, seed, dev):
    import numpy as np

    v = np.asarray(scene.vertices)
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


class Recorder:
    """Intersector proxy that keeps the wavefronts it is asked to trace."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def intersect(self, o, d, tmin, tmax):
        self.calls.append(("nearest", o, d, tmin, tmax))
        return self.inner.intersect(o, d, tmin, tmax)

    def occluded(self, o, d, tmax):
        import torch

        self.calls.append(("anyhit", o, d, torch.zeros_like(tmax), tmax))
        return self.inner.occluded(o, d, tmax)


class PlainIntersector:
    """Intersector proxy that traces the same packed inputs as `inner`
    through the kernels' plain PyTorch versions, with `inner`'s own
    post-processing of the results."""

    def __init__(self, inner):
        self.inner = inner

    def intersect(self, o, d, tmin, tmax):
        from spray_tpu_torch.kernels import traverse

        args, inv = self.inner._args(o, d, tmin, tmax)
        return self.inner._hits(o, d, tmax, args, inv,
                                *traverse.nearest_reference(*args[:-1]))

    def occluded(self, o, d, tmax):
        import torch

        from spray_tpu_torch.kernels import traverse

        args, inv = self.inner._args(o, d, torch.zeros_like(tmax), tmax)
        return traverse.anyhit_reference(*args[:-1])[: o.shape[0]][inv] != 0


def compare_hits(tag, ref, got):
    """The bar of the JAX package's kernel tests."""
    from spray_tpu_torch.parity import hit_mismatch

    s = hit_mismatch(ref, got, t_tol=(2e-4, 2e-5, 0.0), tie_tol=(1e-4, 0.0, 1.0))
    c = s["counts"]
    check(f"{tag} valid masks equal", c["valid_mismatch"] == 0,
          f"({c['valid_mismatch']} differ of {s['lanes']})")
    check(f"{tag} t within rtol 2e-4 atol 2e-5", c["t_bad"] == 0,
          f"(max abs diff {s['t_max_abs']:.3g})")
    rate = s["prim_mismatch_nontie"]
    check(f"{tag} non-tie prim mismatch < 0.2%", rate < 0.002, f"({rate:.5f})")


def compare_raw(tag, kind, ref, got):
    """Kernel vs plain outputs on the same packed inputs; returns max abs err."""
    if kind == "anyhit":
        err = float((ref - got).abs().max()) if ref.numel() else 0.0
        check(f"{tag} occlusion equal", err == 0,
              f"({int((ref != got).sum())} differ of {ref.numel()})")
        return err
    (tr, cr), (tg, cg) = ref, got
    vr, vg = cr >= 0, cg >= 0
    check(f"{tag} hit masks equal", bool((vr == vg).all()),
          f"({int((vr != vg).sum())} differ of {vr.numel()})")
    m = vr & vg
    diff = (tr[m] - tg[m]).abs()
    err = float(diff.max()) if m.any() else 0.0
    check(f"{tag} t within rtol 2e-4 atol 2e-5",
          bool((diff <= 2e-5 + 2e-4 * tr[m].abs()).all()), f"(max abs {err:.3g})")
    mism = (cr[m] != cg[m]) & (diff > 1e-4 * tr[m].clamp(min=1))
    rate = float(mism.float().mean()) if m.any() else 0.0
    check(f"{tag} non-tie code mismatch < 0.2%", rate < 0.002, f"({rate:.5f})")
    return err


def cuda_ms(torch, fn, reps=3):
    """Mean ms of fn() over reps launches, after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed_once(torch, fn):
    """(fn(), its ms by CUDA events) of one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def sample_packets(torch, args, k, dead=0):
    """The call's inputs cut to k live packets spread evenly over its live
    packets (all of them if there are fewer) and its first `dead` dead
    packets, against the full pages.  args[0] is a domain list or a bucket
    map."""
    live = (args[4].view(-1, args[8]) > 0).any(dim=1)
    live_pk = torch.nonzero(live).view(-1)
    if live_pk.numel() > k:
        live_pk = live_pk[torch.linspace(0, live_pk.numel() - 1, k,
                                         device=live_pk.device).long()]
    return pick_packets(torch, args,
                        torch.cat([live_pk, torch.nonzero(~live).view(-1)[:dead]]))


def pick_packets(torch, args, pk):
    """The call's packed inputs cut to the packets `pk` (indices), against
    the full pages."""
    packet = args[8]
    ray_idx = (pk[:, None] * packet
               + torch.arange(packet, device=pk.device)).view(-1)
    return (args[0][pk].contiguous(),
            *[a[ray_idx].contiguous() for a in args[1:5]], *args[5:])


def middle(torch, n, dev):
    """Indices of the WALK_PACKETS middle ones of n packets."""
    k = min(WALK_PACKETS, n)
    return torch.arange(k, device=dev) + (n - k) // 2


def same_bits(torch, ref, got):
    """Tuples of CPU / card tensors equal bit for bit."""
    return all(bool((r.cpu().view(torch.int32) == g.cpu().view(torch.int32)).all())
               for r, g in zip(ref, got))


def per_dom_of(w):
    """Codes of one domain of the (D, Nc, 4, 3C) pages w."""
    return w.shape[1] * (w.shape[3] // 3)


def check_walk(torch, traverse, tag, kind, sub, cpu_pages, slot=False):
    """The kernel of `kind` on the packed inputs `sub` (a few hundred rays)
    == the host's walk_reference: t, code and occlusion bit for bit with no
    tie tolerance, and the three counts.  With slot (`sub` then holds
    one-entry lists) the slot kernel, the same warp walk through its own
    entry point, is held against the same walk in the slot contract:
    domain-local codes, a dead packet's lanes t 0 and code -1."""
    dev = sub[1].device
    *ref, cnt = traverse.walk_reference(sub[0], *sub[1:5], *cpu_pages, sub[8],
                                        occl=kind == "anyhit")
    want = [cnt["nodes"], cnt["leaves"], cnt["tests"]]
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    got = run_kernel(traverse, kind, sub, counters)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    check(f"{tag} {kind}_kernel == walk_reference on {sub[1].shape[0]} rays "
          "(bit-equal, no tie tolerance; node, leaf and test counts equal)",
          same_bits(torch, ref, got) and counters.tolist() == want,
          f"(counts {counters.tolist()} vs {want}, stack high-water "
          f"{cnt['stack_high']})")
    if not slot:
        return
    bucket = sub[0][:, 0].contiguous()
    dom = bucket.repeat_interleave(sub[8]).cpu()
    dead = dom < 0
    local = torch.where(dead | (ref[1] < 0), -1,
                        ref[1] - dom * per_dom_of(cpu_pages[2])).to(torch.int32)
    slot_t = torch.where(dead, torch.zeros_like(ref[0]), ref[0])
    counters.zero_()
    got = traverse.nearest_slot(bucket, *sub[1:], counters=counters)
    torch.cuda.synchronize()
    check(f"{tag} nearest_slot_kernel == walk_reference on {sub[1].shape[0]} "
          f"rays, {int(dead.sum())} in dead packets (bit-equal, no tie "
          "tolerance; counts equal)",
          same_bits(torch, (slot_t, local), got) and counters.tolist() == want,
          f"(counts {counters.tolist()} vs {want})")


def check_designs(torch, traverse, tag, kind, args, cpu_pages, rounds=(0, 1)):
    """One-entry domain lists cut from a call's packed inputs (column r of
    its lists, the packets that have a domain and a live lane there): the
    contract between the two nearest entry points, which share one warp
    walk (nearest_kernel on the lists == nearest_slot_kernel on their bucket
    map: t bit-equal, code equal after the domain offset, no tie tolerance,
    the three counts equal), and the kernels of `kind` against
    walk_reference on WALK_PACKETS of those packets."""
    order, packet = args[0], args[8]
    live = (args[4].view(-1, packet) > 0).any(dim=1)
    dev = order.device
    for r in rounds:
        if r >= order.shape[1]:
            break
        pk = torch.nonzero(live & (order[:, r] >= 0)).view(-1)
        if not pk.numel():
            continue
        sub = pick_packets(torch, args, pk)
        one = (sub[0][:, r:r + 1].contiguous(), *sub[1:])
        check_walk(torch, traverse, f"{tag} round {r} one-entry lists", kind,
                   pick_packets(torch, one, middle(torch, pk.numel(), dev)),
                   cpu_pages, slot=kind == "nearest")
        if kind != "nearest":
            continue
        cw = torch.zeros(3, dtype=torch.int64, device=dev)
        ct = torch.zeros(3, dtype=torch.int64, device=dev)
        t_w, code_w = traverse.nearest(*one, counters=cw)
        torch.cuda.synchronize()
        bucket = one[0][:, 0].contiguous()
        t_t, code_t = traverse.nearest_slot(bucket, *one[1:], counters=ct)
        torch.cuda.synchronize()
        dom = bucket.repeat_interleave(packet)
        local = torch.where(code_w >= 0, code_w - dom * per_dom_of(args[7]), -1)
        check(f"{tag} round {r} nearest_kernel == nearest_slot_kernel on "
              f"{pk.numel()} one-entry packets (t bit-equal, codes equal with "
              "no tie tolerance, counts equal)",
              same_bits(torch, (t_t, code_t), (t_w, local))
              and cw.tolist() == ct.tolist(),
              f"({int((code_t != local).sum())} codes differ; counts "
              f"{cw.tolist()} vs {ct.tolist()})")


def bound_parts(torch, kind, args, counts):
    """(ms for the operations at the fp32 peak, ms for the bytes at the memory
    rate) of one call's work; its bound is the larger.  Bytes: the pages of
    every domain the call lists, each live ray (tmax > 0) and the domain
    lists read once, every lane's outputs written once.  Operations: the
    counted tests and node visits."""
    order, o, tmax, bounds, meta, w = args[0], args[1], args[4], *args[5:8]
    doms = torch.unique(order[order >= 0]).numel()
    page = (bounds[0].numel() + meta[0].numel() + w[0].numel()) * 4
    nbytes = (doms * page + int((tmax > 0).sum()) * 32 + order.numel() * 4
              + o.shape[0] * (8 if kind == "nearest" else 4))
    ops = TEST_OPS * counts[2] + NODE_OPS * counts[0]
    return ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3


def bound_of(t_ops, t_bytes):
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_kernel(traverse, kind, args, counters=None):
    fn = traverse.nearest if kind == "nearest" else traverse.anyhit
    return fn(*args, counters=counters)


def run_plain(traverse, kind, args):
    fn = traverse.nearest_reference if kind == "nearest" else traverse.anyhit_reference
    return fn(*args[:-1])


def profile_top(torch, tag, fn, k=8):
    """One call of fn under torch.profiler: wall time; the device's busy
    time (the union of the intervals of its kernels and copies, so work
    that overlaps on two streams counts once), their summed time and the
    idle share; the k kernels with the most device time, then the k ops
    with the most host time.  Only device events count as device time: an
    aten op's row also carries the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def on_device(e):
        return (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if on_device(e)):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy /= 1e3
    ev = prof.key_averages()
    kern = [e for e in ev if on_device(e)]
    summed = sum(e.self_device_time_total for e in kern) / 1e3
    top_dev = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:k]
    top_cpu = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:k]
    n_dev = sum(e.count for e in kern)
    print(f"profile {tag}: wall {wall:.1f} ms under the profiler, device busy "
          f"{busy:.1f} ms (kernels and copies summed {summed:.1f} ms over "
          f"{n_dev} events), idle share {1 - busy / wall:.3f}; device: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
                      f"x{e.count}" for e in top_dev)
          + " | host: " + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.2f}"
                                    f" ms x{e.count}" for e in top_cpu), flush=True)
    check(f"{tag} profile: device busy <= wall", 0 < busy <= wall,
          f"({busy:.1f} vs {wall:.1f} ms)")
    return {"wall_ms": wall, "device_busy_ms": busy, "device_summed_ms": summed,
            "device_events": n_dev, "idle_share": 1 - busy / wall}


def check_dead_lanes(torch, tag, args, out):
    """A dead packet's lanes (bucket -1) return t 0 and code -1 from the
    slot kernel, no occlusion from the any-hit kernel."""
    dead = args[0].repeat_interleave(args[8]) < 0
    if isinstance(out, tuple):
        t, code = out
        ok = bool((t[dead] == 0).all()) and bool((code[dead] == -1).all())
        what = "t 0, code -1"
    else:
        ok, what = bool((out[dead] == 0).all()), "occlusion 0"
    check(f"{tag} dead packets give {what}", ok, f"({int(dead.sum())} dead lanes)")


class SlotRecorder:
    """While installed, keeps a copy of the inputs of every nearest_slot and
    anyhit call, by kind (the epoch loop rewrites its window buffer in
    place)."""

    NAMES = {"nearest": "nearest_slot", "anyhit": "anyhit"}

    def __init__(self, traverse):
        self.traverse = traverse
        self.inner = {k: getattr(traverse, n) for k, n in self.NAMES.items()}
        self.calls = {k: [] for k in self.NAMES}

    def __enter__(self):
        def recorder(kind):
            def record(order, o, d, tmin, tmax, *rest, counters=None):
                self.calls[kind].append((order.clone(), o, d, tmin, tmax.clone(),
                                         *rest))
                return self.inner[kind](order, o, d, tmin, tmax, *rest,
                                        counters=counters)
            return record

        for kind, name in self.NAMES.items():
            setattr(self.traverse, name, recorder(kind))
        return self

    def __exit__(self, *exc):
        for kind, name in self.NAMES.items():
            setattr(self.traverse, name, self.inner[kind])


def slot_kernel_stats(torch, np, traverse, kind, calls, smi, tag,
                      n_calls=None):
    """One frame's calls of one kernel, recorded by SlotRecorder (kind
    "nearest": the slot kernel; "anyhit": the any-hit kernel on one-entry
    domain lists): every call timed against its bound, and
    n_calls (default SLOT_SAMPLE_CALLS) of them held against the plain
    version on
    SLOT_SAMPLE_PACKETS live packets and one dead packet each; the slot
    kernel also against walk_reference on the middle live packet and that
    dead packet, counts included.  `tag` names the frame."""
    if kind == "nearest":
        fn, plain = traverse.nearest_slot, traverse.nearest_slot_reference
        name = "nearest_slot_kernel"
    else:
        fn, plain, name = traverse.anyhit, traverse.anyhit_reference, "anyhit_kernel"
    counters = torch.zeros(3, dtype=torch.int64, device=calls[0][1].device)
    st = {k: 0.0 for k in ("ms", "ops_ms", "bytes_ms", "s_ms", "s_plain_ms",
                            "s_ops_ms", "s_bytes_ms", "s_err")}
    st.update(calls=len(calls), s_calls=0, s_rays=0, counts=np.zeros(3))
    for args in calls:
        counters.zero_()
        fn(*args, counters=counters)
        cnt = counters.cpu().numpy().astype(np.float64)
        st["ms"] += cuda_ms(torch, lambda: fn(*args))
        ops_ms, bytes_ms = bound_parts(torch, kind, args, cnt)
        st["ops_ms"] += ops_ms
        st["bytes_ms"] += bytes_ms
        st["counts"] += cnt
    live_calls = [a for a in calls if bool((a[0] >= 0).any())]
    pick = np.linspace(0, len(live_calls) - 1, min(n_calls or SLOT_SAMPLE_CALLS,
                                                   len(live_calls))).astype(int)
    for i in sorted(set(pick.tolist())):
        sub = sample_packets(torch, live_calls[i], SLOT_SAMPLE_PACKETS, dead=1)
        counters.zero_()
        got = fn(*sub, counters=counters)
        s_cnt = counters.cpu().numpy().astype(np.float64)
        ref_out, plain_ms = timed_once(torch, lambda: plain(*sub[:-1]))
        ctag = f"{tag} {name} call {i} ({sub[0].shape[0]} packets)"
        st["s_err"] = max(st["s_err"], compare_raw(f"{ctag} kernel~plain", kind,
                                                   ref_out, got))
        check_dead_lanes(torch, f"{ctag} kernel", sub, got)
        if kind == "nearest":
            n_pk = sub[0].shape[0]
            pk = torch.cat([middle(torch, n_pk - 1, sub[0].device),
                            torch.tensor([n_pk - 1], device=sub[0].device)])
            one = (sub[0][:, None].contiguous(), *sub[1:])
            check_walk(torch, traverse, ctag, kind, pick_packets(torch, one, pk),
                       tuple(x.cpu() for x in sub[5:8]), slot=True)
        st["s_ms"] += cuda_ms(torch, lambda: fn(*sub))
        st["s_plain_ms"] += plain_ms
        ops_ms, bytes_ms = bound_parts(torch, kind, sub, s_cnt)
        st["s_ops_ms"] += ops_ms
        st["s_bytes_ms"] += bytes_ms
        st["s_calls"] += 1
        st["s_rays"] += sub[1].shape[0]
    check(f"{tag} {name} held against its plain version", st["s_calls"] > 0,
          f"({st['s_calls']} calls)")
    fb, fby = bound_of(st["ops_ms"], st["bytes_ms"])
    sb, sby = bound_of(st["s_ops_ms"], st["s_bytes_ms"])
    print(f"{tag} {name}: one frame {st['ms']:.3f} ms in "
          f"{len(calls)} launches, {int(st['counts'][2])} tri tests, bound "
          f"{fb:.4f} ms ({fby}); samples ({st['s_rays']} rays over "
          f"{st['s_calls']} calls) {st['s_ms']:.3f} ms vs plain "
          f"{st['s_plain_ms']:.3f} ms, bound {sb:.4f} ms ({sby}), max abs err "
          f"{st['s_err']:.3g}; card {smi}", flush=True)
    st.update(frame_bound_ms=fb, frame_bound_by=fby, bound_ms=sb, bound_by=sby)
    return st


def phase2_slot(torch, traverse, small, brute, waves, dev):
    """The slot kernel through ClusterBVHIntersector on the small scene."""
    cisect = traverse.ClusterBVHIntersector(small, device=dev)
    print(f"phase2: ClusterBVHIntersector, one domain of {small.num_faces} tris, "
          f"tree depth {cisect.depth}", flush=True)
    for tag, (wo, wd, wmin, wmax) in waves:
        args = cisect._args(wo, wd, wmin, wmax)
        got = traverse.nearest_slot(*args)
        ref = traverse.nearest_slot_reference(*args[:-1])
        torch.cuda.synchronize()
        compare_raw(f"phase2 {tag} slot kernel~plain", "nearest", ref, got)
        check_dead_lanes(torch, f"phase2 {tag} slot kernel", args, got)
        check_dead_lanes(torch, f"phase2 {tag} slot plain", args, ref)
        compare_hits(f"phase2 {tag} ClusterBVH kernel~brute",
                     brute.intersect(wo, wd, wmin, wmax),
                     cisect.intersect(wo, wd, wmin, wmax))
    wo, wd, _, _ = waves[0][1]
    far = torch.full((wo.shape[0],), 1e30, device=dev)
    ob, oc = brute.occluded(wo, wd, far), cisect.occluded(wo, wd, far)
    check("phase2 ClusterBVH anyhit kernel~brute occlusion equal",
          bool((ob == oc).all()), f"({int((ob != oc).sum())} differ)")


def phase3_grads(torch, make_pipeline, small, cam64, cfg64, sisect, dev):
    """A 64x64 training step through the kernels == through the plain
    versions: same visibility, so the same loss and gradients up to the
    order of the backward's scatter-adds."""
    outs = [make_pipeline(small, cam64, cfg64, backward=True, intersector=x,
                          device=dev).run()
            for x in (sisect, PlainIntersector(sisect))]
    (lk, gk, nk), (lp, gp, np_) = outs
    check("phase3 64x64 train step kernels~plain loss and rays",
          abs(float(lk) - float(lp)) <= 1e-6 * abs(float(lp)) and int(nk) == int(np_),
          f"(loss {float(lk):.8f} vs {float(lp):.8f}, rays {int(nk)} vs {int(np_)})")
    for k in gp:
        err = float((gk[k] - gp[k]).abs().max())
        tol = 1e-4 * gp[k].abs() + 1e-6 * float(gp[k].abs().max())
        check(f"phase3 64x64 {k} gradients kernels~plain (rtol 1e-4, atol 1e-6 "
              "of the largest)", bool(((gk[k] - gp[k]).abs() <= tol).all())
              and float(gp[k].abs().max()) > 0,
              f"(max abs diff {err:.3g}, max |g| {float(gp[k].abs().max()):.4g})")


SCHED_TIMED = 2  # timed frames of each scheduler configuration, after one warm-up
SLOT_SAMPLE_CALLS = 8  # slot calls of one config-4 frame held against plain
SLOT_SAMPLE_PACKETS = 64  # live packets of each of those calls


def phase5_scheduler(torch, np, scene, cam, md_isect, dev, smi):
    """The speculative epoch scheduler at full size.  Returns (stats of the
    slot kernel and of the one-domain any-hit kernel for the kernels JSON,
    by kind; launch counts of the path)."""
    from bench_torch import SUITE_VARIANTS, suite_row
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.integrators.device import render_device
    from spray_tpu_torch.kernels import traverse
    from spray_tpu_torch.kernels.multidomain import build_cluster_domains
    from spray_tpu_torch.render import render
    from spray_tpu_torch.sched.epochs import OOCIntersector

    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    cfg1 = RenderConfig(width=512, height=512, spp=1, bounces=2,
                        integrator="pt", nee=True, seed=0)
    pages = {}
    for nd in (8, 64):
        t0 = time.perf_counter()
        pages[nd] = build_cluster_domains(scene, nd)
        print(f"phase5: {nd} domains, pages w {pages[nd]['w'].shape}, built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    # the forward multi-domain path over the same 8-domain pages: the
    # reference image, and the wavefronts it traced
    md8 = Recorder(MultiDomainClusterIntersector.from_pages(scene, pages[8],
                                                            device=dev))
    ref = render(scene, cam, cfg1, intersector=md8, device=dev)
    ref21 = render(scene, cam, cfg1, intersector=md_isect, device=dev)
    images, res = {}, {}
    reset_launches()
    for name, nd, slots, kw in SUITE_VARIANTS:
        r, images[name], oc = suite_row(scene, cam, cfg1, nd, slots, dev,
                                        timed=SCHED_TIMED, pages=pages[nd], **kw)
        res[name] = r
        print(f"phase5 {name}: frame {r['frame_s']:.4f} s (times "
              f"{[round(t, 4) for t in r['frame_times_s']]}, warm-up "
              f"{r['warm_s']:.2f} s); per frame: epochs {r['epochs']}, "
              f"activations {r['rays_traced']}, speculated "
              f"{r['rays_speculated']}, committed {r['committed']}, speculation "
              f"efficiency {r['speculation_efficiency']:.4f}, loads "
              f"{r['domain_loads']}, hits {r['cache_hits']}, prefetches "
              f"{r['prefetches']}; lookahead {r['lookahead_active']}, probe "
              f"{r['host_to_hbm_mbps']} MB/s; card {smi}", flush=True)
    launches = read_launches()
    print(f"phase5: launches over the five configurations {launches}", flush=True)
    for k in ("nearest_slot_kernel", "anyhit_kernel"):
        check(f"phase5 {k} launched on the scheduler path", launches[k] > 0,
              f"({launches[k]})")
    first = images[SUITE_VARIANTS[0][0]]
    for name, img in images.items():
        check(f"phase5 {name} image byte-identical to {SUITE_VARIANTS[0][0]}",
              img.tobytes() == first.tobytes(),
              f"(max abs {float(np.abs(img - first).max()):.3g})")
    # Over the same 8 domains every pixel agrees.  Over the bench's 21
    # domains the clusters differ, and two triangles hit within one 128-ulp
    # key quantum (a ray grazing a shared edge) are tied; the traversal order
    # breaks the tie, so a few pixels may take the other triangle's path.
    for tag, r_img, max_px in (("8-domain", ref, 0),
                               ("21-domain", ref21, first[..., 0].size // 10000)):
        far = ~np.isclose(first, r_img, atol=2e-3, rtol=1e-3)
        n_px = int(far.any(axis=2).sum())
        check(f"phase5 scheduler image ~ forward {tag} multi-domain image "
              f"(atol 2e-3, rtol 1e-3; at most {max_px} pixels outside)",
              n_px <= max_px,
              f"(max abs {float(np.abs(first - r_img).max()):.3g}, {n_px} pixels "
              f"outside, mean {first.mean():.6f} vs {r_img.mean():.6f})")
    # hit level: the config-3 scheduler against the forward path on the
    # frame's own bounce and shadow wavefronts
    oc3 = OOCIntersector(scene, n_domains=8, num_slots=8, pages=pages[8],
                         device=dev, lookahead=False)
    for i, (kind, wo, wd, wmin, wmax) in enumerate(md8.calls):
        if kind == "nearest":
            compare_hits(f"phase5 call {i} nearest scheduler~forward",
                         md8.inner.intersect(wo, wd, wmin, wmax),
                         oc3.intersect(wo, wd, wmin, wmax))
        else:
            a, b = md8.inner.occluded(wo, wd, wmax), oc3.occluded(wo, wd, wmax)
            check(f"phase5 call {i} anyhit scheduler~forward occlusion equal",
                  bool((a == b).all()), f"({int((a != b).sum())} differ)")
    del md8, oc3
    check("phase5 finite nonzero image", bool(np.isfinite(first).all())
          and first.mean() > 0, f"(mean {first.mean():.6f})")
    check("phase5 speculative epochs <= baseline epochs",
          res["config3_speculative"]["epochs"] <= res["config3_baseline"]["epochs"],
          f"({res['config3_speculative']['epochs']:g} vs "
          f"{res['config3_baseline']['epochs']:g})")

    # both kernels over every call of one config-4 frame, and against their
    # plain versions on sampled calls of it
    prof = profile_top(torch, "phase5 config4_noprefetch frame",
                       lambda: render_device(scene, cam, cfg1, intersector=oc,
                                             device=dev))
    with SlotRecorder(traverse) as recorder:
        render_device(scene, cam, cfg1, intersector=oc, device=dev)
    st = {kind: slot_kernel_stats(torch, np, traverse, kind,
                                  recorder.calls[kind], smi,
                                  "phase5 config4_noprefetch frame")
          for kind in ("nearest", "anyhit")}
    st["nearest"].update(configs=res, profile=prof)
    del recorder
    return st, launches


def phase6_train(torch, scene, cam, cfg, isect, dev, smi):
    """The training step at full size.  Returns (its numbers, launch counts
    of the path, its step time, loss and gradients for phase 8)."""
    from spray_tpu_torch.render import make_pipeline

    pipe = make_pipeline(scene, cam, cfg, backward=True, intersector=isect,
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.run()  # warm-up step
    warm = time.perf_counter() - t0
    reset_launches()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.run()  # synchronises the card before returning
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    loss, grads, _ = out
    rays = pipe.rays_traced(out)
    step = min(times)
    prof = profile_top(torch, "phase6 train step", pipe.run)
    peak = torch.cuda.max_memory_allocated()
    norms = {k: float(g.norm()) for k, g in grads.items()}
    print(f"phase6: train step times {[round(t, 4) for t in times]} s; min "
          f"{step:.4f} s (warm-up {warm:.2f} s); rays_traced {rays}; "
          f"{rays / step / 1e9:.6f} Grays/s fwd+bwd; peak memory "
          f"{peak / 2**30:.3f} GiB; loss {float(loss):.8f}; gradient norms "
          f"{norms}; launches over 3 steps {launches}; card {smi}", flush=True)
    for k, g in grads.items():
        check(f"phase6 {k} gradients finite and nonzero",
              bool(torch.isfinite(g).all()) and norms[k] > 0,
              f"(norm {norms[k]:.6g})")
    check("phase6 loss finite", bool(torch.isfinite(loss)), f"({float(loss)})")
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"phase6 {k} launched on the training path", launches[k] > 0,
              f"({launches[k]})")
    ref = {"step_s": step, "loss": float(loss),
           "grads": {k: g.cpu().numpy() for k, g in grads.items()}}
    return {"step_s": step, "warm_s": warm, "rays_traced": rays,
            "grays_per_sec_fwd_bwd": rays / step / 1e9, "peak_gib": peak / 2**30,
            "loss": float(loss), "grad_norms": norms, "profile": prof}, launches, ref


def kernel_modules():
    from spray_tpu_torch.core import rng
    from spray_tpu_torch.kernels import binned, brute, traverse

    return traverse, brute, binned, rng


def reset_launches():
    """Every kernel's launch count and every collective count to 0."""
    from spray_tpu_torch import dist

    for m in kernel_modules():
        m.reset_launches()
    dist.reset_collectives()


def read_launches():
    return {k: v for m in kernel_modules() for k, v in m.launches.items()}


def compare_exact(tag, ref, got):
    """Kernel vs plain outputs that must be bit-equal: tuples of tensors
    (or one tensor); float outputs equal where finite and infinite in the
    same places.  Returns the max abs difference over the float outputs."""
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    err, same = 0.0, True
    for r, g in zip(ref, got):
        if r.is_floating_point():
            fin = r.isfinite() & g.isfinite()
            same &= bool((r.isfinite() == g.isfinite()).all())
            same &= bool((r[~fin] == g[~fin]).all())
            if fin.any():
                err = max(err, float((r[fin] - g[fin]).abs().max()))
        else:
            same &= bool((r == g).all())
    check(f"{tag} kernel == plain (max_abs_err 0, codes and occlusion equal)",
          same and err == 0.0, f"(max abs err {err:.3g} over {ref[0].numel()} lanes)")
    return err


def image_close(tag, img, ref, np, max_px):
    """Images within atol 2e-3, rtol 1e-3 on all but max_px pixels."""
    img, ref = (x.cpu().numpy() if hasattr(x, "cpu") else x for x in (img, ref))
    far = ~np.isclose(img, ref, atol=2e-3, rtol=1e-3)
    n_px = int(far.any(axis=2).sum())
    check(f"{tag} (atol 2e-3, rtol 1e-3; at most {max_px} pixels outside)",
          n_px <= max_px,
          f"(max abs {float(np.abs(img - ref).max()):.3g}, {n_px} pixels outside, "
          f"mean {img.mean():.6f} vs {ref.mean():.6f})")
    return n_px


class VisitRecorder:
    """While installed, keeps the arguments of every nearest_visits and
    anyhit_visits call of the binned and sweep tracers, grouped by the
    intersect / occluded call that made them (`mark` opens a group)."""

    NAMES = {"nearest": "nearest_visits", "anyhit": "anyhit_visits"}

    def __init__(self):
        from spray_tpu_torch.kernels import binned, sweep

        self.mods = (binned, sweep)
        self.inner = {k: getattr(binned, n) for k, n in self.NAMES.items()}
        self.groups = []

    def mark(self, kind):
        self.groups.append((kind, []))

    def __enter__(self):
        def recorder(kind):
            def record(*args, **kw):
                assert self.groups and self.groups[-1][0] == kind
                self.groups[-1][1].append(args)
                return self.inner[kind](*args, **kw)
            return record

        for kind, name in self.NAMES.items():
            for mod in self.mods:
                setattr(mod, name, recorder(kind))
        return self

    def __exit__(self, *exc):
        for kind, name in self.NAMES.items():
            for mod in self.mods:
                setattr(mod, name, self.inner[kind])


class Marked:
    """Intersector proxy that opens a VisitRecorder group per call."""

    def __init__(self, inner, recorder):
        self.inner, self.recorder = inner, recorder

    def intersect(self, o, d, tmin, tmax):
        self.recorder.mark("nearest")
        return self.inner.intersect(o, d, tmin, tmax)

    def occluded(self, o, d, tmax):
        self.recorder.mark("anyhit")
        return self.inner.occluded(o, d, tmax)


def visit_fns(kind):
    from spray_tpu_torch.kernels import binned

    if kind == "nearest":
        return binned.nearest_visits, binned.nearest_visits_reference
    return binned.anyhit_visits, binned.anyhit_visits_reference


def visit_bound_parts(torch, kind, args, tests):
    """(ms for the operations at the fp32 peak, ms for the bytes at the
    memory rate, gated clusters) of one visit launch.  Operations: MT_OPS
    per ray-triangle test; nearest tests every lane of a packet against
    every triangle of every gated cluster of its run, any-hit the tests
    the serial order needs (`tests`, from binned.anyhit_serial_tests: none
    on a lane occluded at input or with an empty window, the others up to
    and including their first hit).  Bytes: each gated cluster's 9 x 128
    floats, per run one packet of rays and its state in and out, and the
    visit list."""
    cmask, first, last = args[2], args[3], args[4]
    is_last = last != 0
    opened = (first != 0).cumsum(0) - (is_last.cumsum(0) - is_last.long())
    bits = ((cmask[:, None] >> torch.arange(8, device=cmask.device)) & 1).sum(dim=1)
    clusters = int(bits[opened > 0].sum())
    runs = int((first != 0).sum())
    if kind == "nearest":
        tests = clusters * 128 * 128
    per_ray = 28 + 16 if kind == "nearest" else 32 + 8
    nbytes = clusters * 128 * 36 + runs * 128 * per_ray + cmask.numel() * 20
    return tests * MT_OPS / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3, clusters


def run_spans(np, first, last):
    """(first visit, last visit) index arrays of the runs of a visit list's
    host flags."""
    starts, ends = np.nonzero(first)[0], np.nonzero(last)[0]
    return starts, ends[np.minimum(np.searchsorted(ends, starts), len(ends) - 1)]


def sample_runs(torch, np, vlist, k):
    """The visit list cut to k of its runs that gate a cluster (all of them
    if fewer): the k // 2 longest, the others spread evenly over the rest,
    each cut to its first VISIT_SAMPLE_LEN visits (a shorter run of the same
    packet: the `last` flag moves to the cut); rays and state stay whole.
    Returns (the cut list, the cut runs' lengths), or None."""
    cols = [x.cpu().numpy().copy() for x in vlist]
    cmask, first, last = cols[2], cols[3], cols[4]
    live = [(a, b) for a, b in zip(*run_spans(np, first, last))
            if cmask[a:b + 1].any()]
    if not live:
        return None
    if len(live) > k:
        longest = sorted(range(len(live)), key=lambda j: live[j][0] - live[j][1])
        keep = set(longest[:k // 2])
        rest = [j for j in range(len(live)) if j not in keep]
        keep |= {rest[j] for j in np.linspace(0, len(rest) - 1,
                                               k - len(keep)).astype(int)}
        live = [live[j] for j in sorted(keep)]
    live = [(a, min(b, a + VISIT_SAMPLE_LEN - 1)) for a, b in live]
    last[[b for _, b in live]] = 1
    idx = np.concatenate([np.arange(a, b + 1) for a, b in live])
    return (tuple(torch.as_tensor(np.ascontiguousarray(c[idx]),
                                  device=vlist[0].device) for c in cols),
            [b - a + 1 for a, b in live])


def visit_spans():
    """Visits one block walks, by kind, from the built library."""
    from spray_tpu_torch.kernels import _build

    lib = _build.load("binned")
    return {"nearest": lib.spray_binned_span(),
            "anyhit": lib.spray_binned_anyhit_span()}


def visit_kernel_stats(torch, np, tag, groups, smi):
    """One frame's visit launches, grouped by trace call: every launch timed
    against its bound (the any-hit's: the tests the serial order needs,
    with the tests its blocks did beside them), the runs per launch, the
    longest and median run and the blocks launched of each trace call, and
    VISIT_SAMPLE_LAUNCHES launches of each trace call held against the
    plain version on VISIT_SAMPLE_RUNS runs each (some longer than the
    kernel's span of visits a block, so that the cross-block merge is
    compared).  Returns stats by kind."""
    from spray_tpu_torch.kernels import binned

    spans = visit_spans()
    dev = groups[0][1][0][0].device
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    keys = ("ms", "ops_ms", "bytes_ms", "s_ms", "s_plain_ms", "s_ops_ms",
            "s_bytes_ms", "s_err")
    st = {k: {**dict.fromkeys(keys, 0.0), "launches": 0, "visits": 0,
              "clusters": 0, "s_launches": 0, "s_runs": 0, "s_long_runs": 0,
              "blocks": 0, "runs": 0, "longest_run": 0, "kernel_tests": 0,
              "serial_tests": 0}
          for k in ("nearest", "anyhit")}

    def tests_of(fn, kind, args):
        """(tests the serial order needs, tests the kernel did) of an
        any-hit launch; (None, None) for the nearest."""
        if kind == "nearest":
            return None, None
        counter.zero_()
        fn(*args, counter=counter)
        serial = int(binned.anyhit_serial_tests(*args).sum())
        return serial, int(counter)

    for gi, (kind, calls) in enumerate(groups):
        fn, plain = visit_fns(kind)
        s = st[kind]
        span = spans[kind]
        runs_per, lengths, blocks = [], [], 0
        for args in calls:
            tests, done = tests_of(fn, kind, args)
            if kind == "anyhit":
                s["serial_tests"] += tests
                s["kernel_tests"] += done
            _, ms = timed_once(torch, lambda: fn(*args))
            ops_ms, bytes_ms, clusters = visit_bound_parts(torch, kind, args, tests)
            s["ms"] += ms
            s["ops_ms"] += ops_ms
            s["bytes_ms"] += bytes_ms
            s["launches"] += 1
            s["visits"] += args[0].numel()
            s["clusters"] += clusters
            a, b = run_spans(np, args[3].cpu().numpy(), args[4].cpu().numpy())
            runs_per.append(len(a))
            lengths.extend((b - a + 1).tolist())
            blocks += -(-args[0].numel() // span)  # a block per span of visits
        s["blocks"] += blocks
        s["runs"] += len(lengths)
        s["longest_run"] = max([s["longest_run"], *lengths])
        print(f"{tag} call {gi} {kind}: {len(calls)} launches; runs per launch "
              f"min {min(runs_per)} median {int(np.median(runs_per))} max "
              f"{max(runs_per)}; run length (visits) longest {max(lengths)} "
              f"median {int(np.median(lengths))}; blocks launched {blocks} (one per "
              f"{span} visits)",
              flush=True)
        pick = np.linspace(0, len(calls) - 1,
                           min(VISIT_SAMPLE_LAUNCHES, len(calls))).astype(int)
        for i in sorted(set(pick.tolist())):
            sampled = sample_runs(torch, np, calls[i][:5], VISIT_SAMPLE_RUNS)
            if sampled is None:
                continue
            sub = (*sampled[0], *calls[i][5:])
            s["s_long_runs"] += sum(n > span for n in sampled[1])
            got = fn(*sub)
            ref, plain_ms = timed_once(torch, lambda: plain(*sub))
            runs = int((sub[3] != 0).sum())
            s["s_err"] = max(s["s_err"], compare_exact(
                f"{tag} call {gi} {kind} launch {i} ({runs} runs)", ref, got))
            ops_ms, bytes_ms, _ = visit_bound_parts(torch, kind, sub,
                                                    tests_of(fn, kind, sub)[0])
            s["s_ms"] += cuda_ms(torch, lambda: fn(*sub))
            s["s_plain_ms"] += plain_ms
            s["s_ops_ms"] += ops_ms
            s["s_bytes_ms"] += bytes_ms
            s["s_launches"] += 1
            s["s_runs"] += runs
    for kind, s in st.items():
        name, span = f"binned_{kind}_kernel", spans[kind]
        check(f"{tag} {name} held against its plain version", s["s_launches"] > 0,
              f"({s['s_launches']} launches, {s['s_runs']} runs, "
              f"{s['s_long_runs']} longer than {span} visits)")
        if s["longest_run"] > span:
            check(f"{tag} {name}: sampled runs cross blocks", s["s_long_runs"] > 1,
                  f"({s['s_long_runs']} sampled runs longer than {span} visits)")
        if kind == "anyhit":
            s["extra_work"] = s["kernel_tests"] / max(1, s["serial_tests"])
            print(f"{tag} {name}: one frame's tests: {s['serial_tests']} that the "
                  f"serial order needs (the bound), {s['kernel_tests']} that the "
                  f"kernel's blocks did ({s['extra_work']:.4f} x)", flush=True)
        fb, fby = bound_of(s["ops_ms"], s["bytes_ms"])
        sb, sby = bound_of(s["s_ops_ms"], s["s_bytes_ms"])
        s.update(frame_bound_ms=fb, frame_bound_by=fby, bound_ms=sb, bound_by=sby)
        print(f"{tag} {name}: one frame {s['ms']:.3f} ms in {s['launches']} "
              f"launches, {s['visits']} visits, {s['clusters']} gated clusters, "
              f"bound {fb:.4f} ms ({fby}); samples ({s['s_runs']} runs over "
              f"{s['s_launches']} launches) {s['s_ms']:.3f} ms vs plain "
              f"{s['s_plain_ms']:.3f} ms, bound {sb:.4f} ms ({sby}), max abs err "
              f"{s['s_err']:.3g}; card {smi}", flush=True)
    return st


def timed_frames(torch, run, n):
    """(warm-up s, [frame s] * n, last output) of run(), which synchronises
    the card before it returns (a Pipeline's run); launch and collective
    counts are set to 0 after the warm-up frame."""
    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    reset_launches()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    return warm, times, out


def phase2_alternates(torch, np, small, oracle, waves, dev):
    """Small-scene parity of the four new kernels: each against its plain
    version (bit-equal) and, through its intersector, against the torch
    brute oracle; the visit kernels on the visit lists of real
    BinnedIntersector and SweepIntersector calls."""
    from spray_tpu_torch.kernels import binned, brute, sweep

    pb = brute.PallasBruteIntersector(small, device=dev)
    for tag, kind, rays in waves:
        wo, wd, wmin, wmax = (x.contiguous() for x in rays)
        if kind == "nearest":
            got = brute.brute_nearest(pb.tri9, pb.ids, wo, wd, wmin, wmax)
            ref = brute.brute_nearest_reference(pb.tri9, pb.ids, wo, wd, wmin, wmax)
            compare_exact(f"phase2 {tag} brute_nearest_kernel", ref, got)
            compare_hits(f"phase2 {tag} PallasBrute kernel~brute oracle",
                         oracle.intersect(wo, wd, wmin, wmax),
                         pb.intersect(wo, wd, wmin, wmax))
        else:
            got = brute.brute_anyhit(pb.tri9, pb.ids, wo, wd, wmin, wmax)
            ref = brute.brute_anyhit_reference(pb.tri9, pb.ids, wo, wd, wmin, wmax)
            compare_exact(f"phase2 {tag} brute_anyhit_kernel", ref, got)
            a, b = oracle.occluded(wo, wd, wmax), pb.occluded(wo, wd, wmax)
            check(f"phase2 {tag} PallasBrute anyhit~brute oracle occlusion equal",
                  bool((a == b).all()), f"({int((a != b).sum())} differ)")
    for cls in (binned.BinnedIntersector, sweep.SweepIntersector):
        isect = cls(small, device=dev)
        rec = VisitRecorder()
        marked = Marked(isect, rec)
        with rec:
            for tag, kind, (wo, wd, wmin, wmax) in waves:
                name = f"phase2 {tag} {cls.__name__}"
                if kind == "nearest":
                    compare_hits(f"{name} kernel~brute oracle",
                                 oracle.intersect(wo, wd, wmin, wmax),
                                 marked.intersect(wo, wd, wmin, wmax))
                else:
                    a, b = oracle.occluded(wo, wd, wmax), marked.occluded(wo, wd, wmax)
                    check(f"{name} anyhit~brute oracle occlusion equal",
                          bool((a == b).all()), f"({int((a != b).sum())} differ)")
        print(f"phase2 {cls.__name__}: {isect.sbox.shape[0]} supernodes, loop "
              f"counts over {len(waves)} calls {isect.stats}", flush=True)
        for (kind, calls), (tag, _, _) in zip(rec.groups, waves):
            fn, plain = visit_fns(kind)
            pick = np.linspace(0, len(calls) - 1, min(4, len(calls))).astype(int)
            for i in sorted(set(pick.tolist())):
                compare_exact(f"phase2 {tag} {cls.__name__} binned_{kind}_kernel "
                              f"launch {i} ({calls[i][0].numel()} visits)",
                              plain(*calls[i]), fn(*calls[i]))


def phase2_bvh(torch, small, waves, dev, smi):
    """The modules that walk a BVH in batched torch ops (no kernel of their
    own) on the card: BVHIntersector against the brute kernels (valid,
    occlusion and prims equal, t within rtol 2e-4) and the jnp out-of-core
    backend against the cluster backend on the same rays (committed hits
    to the bar of compare_hits: their partitions and triangle tests differ;
    occlusion equal); the wall time of each; and the selector's choice on
    the card."""
    from spray_tpu_torch.bvh.traverse import BVHIntersector
    from spray_tpu_torch.kernels.brute import PallasBruteIntersector
    from spray_tpu_torch.render import default_intersector
    from spray_tpu_torch.sched.epochs import OOCIntersector

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    bvh, build_s = timed(lambda: BVHIntersector(small, device=dev))
    ooc_j, jnp_s = timed(lambda: OOCIntersector(
        small, n_domains=8, num_slots=4, backend="jnp", device=dev))
    ooc_c = OOCIntersector(small, n_domains=8, num_slots=4, backend="cluster",
                           device=dev)
    pb = PallasBruteIntersector(small, device=dev)
    print(f"phase2 bvh: BVHIntersector {tuple(bvh.bvh.child_node.shape)} nodes "
          f"built in {build_s:.2f} s; jnp OOC partitioned in {jnp_s:.2f} s; "
          f"card {smi}", flush=True)
    for tag, kind, rays in waves:
        wo, wd, wmin, wmax = (x.contiguous() for x in rays)
        if kind == "nearest":
            ref = pb.intersect(wo, wd, wmin, wmax)
            got, bvh_s = timed(lambda: bvh.intersect(wo, wd, wmin, wmax))
            compare_hits(f"phase2 {tag} BVHIntersector~brute kernels", ref, got)
            # one triangle test in both: a prim differs only on an exact
            # tie, where the brute takes the lowest row and the walk its own
            differ = ref.prim != got.prim
            check(f"phase2 {tag} BVHIntersector~brute kernels prims equal but "
                  "on exact ties", not bool((differ & (ref.t != got.t)).any()),
                  f"({int(differ.sum())} differ, all at equal t)")
            hc, c_s = timed(lambda: ooc_c.intersect(wo, wd, wmin, wmax))
            hj, j_s = timed(lambda: ooc_j.intersect(wo, wd, wmin, wmax))
            compare_hits(f"phase2 {tag} OOC jnp~cluster committed hits", hc, hj)
            n_diff = int((hc.prim != hj.prim).sum())
        else:
            ref = pb.occluded(wo, wd, wmax)
            got, bvh_s = timed(lambda: bvh.occluded(wo, wd, wmax))
            check(f"phase2 {tag} BVHIntersector~brute kernels occlusion equal",
                  bool((ref == got).all()), f"({int((ref != got).sum())} differ)")
            hc, c_s = timed(lambda: ooc_c.occluded(wo, wd, wmax))
            hj, j_s = timed(lambda: ooc_j.occluded(wo, wd, wmax))
            n_diff = int((hc != hj).sum())
            check(f"phase2 {tag} OOC jnp~cluster occlusion equal", n_diff == 0,
                  f"({n_diff} differ)")
        print(f"phase2 {tag} {kind} ({wo.shape[0]} lanes): BVHIntersector "
              f"{bvh_s * 1e3:.1f} ms; OOC jnp {j_s * 1e3:.1f} ms vs cluster "
              f"{c_s * 1e3:.1f} ms ({n_diff} lanes differ); card {smi}",
              flush=True)
    print(f"phase2 OOC jnp: {ooc_j.stats}; cluster: {ooc_c.stats}", flush=True)
    auto = type(default_intersector(small, device=dev)).__name__
    check("phase2 default_intersector(prefer='auto') on the card is the "
          "multi-domain cluster intersector",
          auto == "MultiDomainClusterIntersector", f"({auto})")


def check_split_tie(torch, np, small, dev):
    """One constructed launch of binned_nearest_kernel == its plain version
    bit for bit: tri9 gets a copy of supernode 0, and packet 0 visits the
    original first and the copy last in one run of more than 4 spans of the
    split kernel (packet 1 the other way round), so every ray whose nearest
    triangle lies in that supernode hits it at two visit indices in blocks
    apart and must keep the earlier; a short run with the null supernode
    and a packet with no run lie beside them."""
    from spray_tpu_torch.kernels import _build, binned

    span = _build.load("binned").spray_binned_span()
    b = binned.BinnedScene(np.asarray(small.vertices), np.asarray(small.faces))
    s, group_c = b.num_supernodes, binned.GROUP * binned.CLUSTER
    tri9 = np.concatenate([b.tri9[:s], b.tri9[:1], b.tri9[s:]])  # copy at s
    n = 4 * binned.BP
    rs = np.random.RandomState(5)
    lo, hi = b.sbox[0, :3], b.sbox[0, 3:]
    o = np.tile((lo + hi) / 2 + np.float32([0, 0, 4.0 * float((hi - lo).max()) + 8]),
                (n, 1)).astype(np.float32)
    d = lo + rs.uniform(size=(n, 3)) * (hi - lo) - o  # aimed at supernode 0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    middle = [1 + j % (s - 1) for j in range(4 * span + 3)]
    visits = []
    for p, run in ((0, [0, *middle, s]), (1, [s, *middle, 0])):
        visits += [(p, x, 0xFF, int(j == 0), int(j == len(run) - 1))
                   for j, x in enumerate(run)]
    visits += [(2, 2, 0x3C, 1, 0), (2, s + 1, 0, 0, 1)]
    vis = np.array(visits, np.int32)
    cols = [torch.as_tensor(np.ascontiguousarray(vis[:, i]), device=dev)
            for i in range(5)]
    rays = [torch.as_tensor(x, device=dev) for x in (o, d, np.zeros(n, np.float32))]
    t0 = torch.full((n,), float("inf"), device=dev)
    c0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tri9 = torch.as_tensor(tri9, device=dev)
    got = binned.nearest_visits(*cols, *rays, tri9, t0, c0)
    torch.cuda.synchronize()
    ref = binned.nearest_visits_reference(*cols, *rays, tri9, t0, c0)
    compare_exact(f"phase2 constructed binned_nearest_kernel launch ({len(vis)} "
                  f"visits, runs of {len(middle) + 2} over blocks of {span})",
                  ref, got)
    sn_of = (got[1] // group_c).view(-1, binned.BP).cpu()
    early = [int((sn_of[p] == x).sum()) for p, x in ((0, 0), (1, s))]
    late = [int((sn_of[p] == x).sum()) for p, x in ((0, s), (1, 0))]
    check("phase2 constructed launch: rays tied between a supernode and its "
          "copy keep the earlier visit", min(early) > 0 and max(late) == 0,
          f"(earlier copy kept on {early} lanes of packets 0, 1; later on {late})")


def check_split_anyhit(torch, np, dev):
    """Constructed launches of binned_anyhit_kernel, each == its plain
    version: a run over many spans whose only hit lies in its last span; a
    run whose hit lies in its first span (the later spans find nothing and
    must keep the 1); a packet occluded at input (and one with some lanes
    occluded); visits between a run's `last` and the next `first`.  The
    table: supernode 0 holds one triangle (z = 0) at row 5 of cluster 0,
    supernode 1 the same at z = -1, supernode 2 real triangles that no ray
    reaches, supernode 3 the null one; 3 packets of rays look down -z from
    z = 2, some with windows that end first or are empty."""
    from spray_tpu_torch.kernels import binned

    span = visit_spans()["anyhit"]
    group_c, bp = binned.GROUP * binned.CLUSTER, binned.BP
    tri9 = np.zeros((4, 9, group_c), np.float32)
    for sn, z in ((0, 0.0), (1, -1.0)):
        tri9[sn, 2, 5] = z
        tri9[sn, 3, 5] = tri9[sn, 7, 5] = 1.0  # e1 = (1, 0, 0), e2 = (0, 1, 0)
    tri9[2, 0] = 100.0  # v0 = (100, 0, 0)
    tri9[2, 3] = tri9[2, 7] = 1.0
    n = 3 * bp
    rs = np.random.RandomState(11)
    o = np.concatenate([rs.uniform(0.0, 0.5, (n, 2)), np.full((n, 1), 2.0)],
                       axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[3::17] = 1.5  # ends before either triangle
    tmax[5::19] = 0.0  # empty
    far, length = [2, 0xFF], 6 * span + 1

    def run(p, sns):
        return [(p, *x, int(j == 0), int(j == len(sns) - 1))
                for j, x in enumerate(sns)]

    occ_some = np.zeros(n, np.int32)
    occ_some[:bp] = 1
    occ_some[bp:2 * bp:3] = 1
    none = np.zeros(n, np.int32)
    cases = [  # (name, visits, input flags, packets whose run reaches a hit)
        ("hit only in the last span", run(0, [far] * (length - 1) + [[0, 1]]),
         none, [0]),
        ("hit in the first span", run(0, [[0, 1]] + [far] * (length - 1)),
         none, [0]),
        ("packets occluded at input", run(0, [[0, 1]] + [far] * length)
         + run(1, [far] * length + [[1, 1]]), occ_some, [0, 1]),
        ("visits between a last and the next first", run(0, [far, far])
         + [(1, 0, 1, 0, 0), (1, 1, 1, 0, 0)] + run(2, [[1, 1]]), none, [2]),
    ]
    rays = [torch.as_tensor(x, device=dev) for x in (o, d, tmin, tmax)]
    tri9 = torch.as_tensor(tri9, device=dev)
    hits = (tmax > 2.0).astype(np.int32)  # lanes whose window reaches z = 0
    for name, visits, occ, hit_packets in cases:
        vis = np.array(visits, np.int32)
        cols = [torch.as_tensor(np.ascontiguousarray(vis[:, i]), device=dev)
                for i in range(5)]
        occ_t = torch.as_tensor(occ, device=dev)
        got = binned.anyhit_visits(*cols, *rays, tri9, occ_t)
        torch.cuda.synchronize()
        ref = binned.anyhit_visits_reference(*cols, *rays, tri9, occ_t)
        compare_exact(f"phase7 constructed binned_anyhit_kernel launch, {name} "
                      f"({len(vis)} visits, blocks of {span})", ref, got)
        want = occ.copy()
        for p in hit_packets:
            want[p * bp:(p + 1) * bp] |= hits[p * bp:(p + 1) * bp]
        check(f"phase7 constructed launch, {name}: the expected flags",
              bool((got.cpu().numpy() == want).all()),
              f"({int(want.sum())} lanes occluded)")


def phase3_alternates(torch, np, small, cam64, cfg64, sisect, img_k, dev):
    """The 64x64 PT+NEE frame through every routed mode (byte-identical to
    the default's) and through the binned, sweep and brute-kernel
    intersectors (the hit tests differ in formula: to the tolerance)."""
    from spray_tpu_torch.kernels.brute import PallasBruteIntersector
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
    from spray_tpu_torch.render import default_intersector, render

    for routed in ("grid", "global", True, False):
        x = MultiDomainClusterIntersector(small, n_domains=sisect.n_domains,
                                          device=dev, routed=routed)
        img = render(small, cam64, cfg64, intersector=x, device=dev)
        check(f"phase3 64x64 routed={routed!r} byte-identical to routed='fused'",
              img.tobytes() == img_k.tobytes(),
              f"(max abs {float(np.abs(img - img_k).max()):.3g})")
    for tag, x in (
        ("prefer='binned'", default_intersector(small, "binned", device=dev)),
        ("prefer='sweep'", default_intersector(small, "sweep", device=dev)),
        ("PallasBruteIntersector", PallasBruteIntersector(small, device=dev)),
    ):
        img = render(small, cam64, cfg64, intersector=x, device=dev)
        image_close(f"phase3 64x64 {tag} ~ default intersector", img, img_k, np,
                    img_k[..., 0].size // TIE_PIXELS)


def phase7_visit_path(torch, np, prefer, scene, cam, cfg, img_ref, dev, smi):
    """The forward bench frame through prefer="sweep" or "binned".  Returns
    (frame numbers, visit-kernel stats by kind, launch counts)."""
    from spray_tpu_torch.kernels import binned
    from spray_tpu_torch.render import default_intersector, make_pipeline

    tag = f"phase7 {prefer}"
    t0 = time.perf_counter()
    isect = default_intersector(scene, prefer=prefer, device=dev)
    t_build = time.perf_counter() - t0
    pipe = make_pipeline(scene, cam, cfg, backward=False, intersector=isect,
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    warm, times, out = timed_frames(torch, pipe.run, ALT_TIMED)
    launches = read_launches()
    frame, rays = min(times), pipe.rays_traced(out)
    peak = torch.cuda.max_memory_allocated()
    # the profiled frame doubles as the recorded one: a proxy keeps the
    # arguments of its visit launches for the per-kernel numbers below
    rec = VisitRecorder()
    rpipe = make_pipeline(scene, cam, cfg, backward=False,
                          intersector=Marked(isect, rec), device=dev)
    isect.stats = binned.new_stats()  # the loops' counts of one frame
    with rec:
        prof = profile_top(torch, f"{tag} forward frame", rpipe.run)
    loop = dict(isect.stats)
    print(f"{tag}: {type(isect).__name__}, {isect.sbox.shape[0]} supernodes, "
          f"tri9 {tuple(isect.tri9.shape)}, built in {t_build:.2f} s; frame times "
          f"{[round(t, 4) for t in times]} s; min {frame:.4f} s (warm-up "
          f"{warm:.2f} s); rays_traced {rays}; {rays / frame / 1e9:.6f} Grays/s; "
          f"peak memory {peak / 2**30:.3f} GiB; per frame: {loop['calls']} trace "
          f"calls, {loop['rounds']} rounds or chunks, {loop['visits']} visits "
          f"launched, {loop['syncs']} host syncs "
          f"({loop['syncs'] / max(1, loop['calls']):.1f} per call); launches over "
          f"{ALT_TIMED} frames {launches}; card {smi}", flush=True)
    img = out[0]
    check(f"{tag} image finite and nonzero",
          bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
          f"(mean {float(img.mean()):.6f})")
    n_px = image_close(f"{tag} image ~ the default intersector's", img, img_ref,
                       np, img_ref[..., 0].numel() // TIE_PIXELS)
    for k in ("binned_nearest_kernel", "binned_anyhit_kernel"):
        check(f"{tag} {k} launched on the path", launches[k] > 0, f"({launches[k]})")
    kst = visit_kernel_stats(torch, np, tag, rec.groups, smi)
    res = {"frame_s": frame, "warm_s": warm, "build_s": t_build,
           "rays_traced": rays, "grays_per_sec": rays / frame / 1e9,
           "peak_gib": peak / 2**30, "per_frame": loop, "pixels_outside": n_px,
           "profile": prof}
    return res, kst, launches


def phase7_routed(torch, np, scene, pages, cam, cfg, isect, img_ref, shadows,
                  dev, smi):
    """The forward bench frame through routed="grid" (one launch per round),
    its slot and one-entry any-hit calls over one frame (`slot_kernel_stats`),
    and the fused any-hit against the per-round form on the default frame's
    shadow wavefronts.  Returns (numbers, kernel stats by kind, launch
    counts)."""
    from spray_tpu_torch.kernels import traverse
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector
    from spray_tpu_torch.render import make_pipeline

    grid = MultiDomainClusterIntersector.from_pages(scene, pages, device=dev,
                                                    routed="grid")
    pipe = make_pipeline(scene, cam, cfg, backward=False, intersector=grid,
                         device=dev)
    warm, times, out = timed_frames(torch, pipe.run, ALT_TIMED)
    launches = read_launches()
    frame, rays = min(times), pipe.rays_traced(out)
    prof = profile_top(torch, "phase7 routed='grid' forward frame", pipe.run)
    print(f"phase7 routed='grid': frame times {[round(t, 4) for t in times]} s; "
          f"min {frame:.4f} s (warm-up {warm:.2f} s); rays_traced {rays}; "
          f"{rays / frame / 1e9:.6f} Grays/s; launches over {ALT_TIMED} frames "
          f"{launches}; card {smi}", flush=True)
    check("phase7 routed='grid' image byte-identical to routed='fused'",
          bool((out[0] == img_ref).all()),
          f"(max abs {float((out[0] - img_ref).abs().max()):.3g})")
    for k in ("nearest_slot_kernel", "anyhit_kernel"):
        check(f"phase7 routed='grid' {k} launched on the path", launches[k] > 0,
              f"({launches[k]})")
    with SlotRecorder(traverse) as recorder:
        pipe.run()
    kst = {kind: slot_kernel_stats(torch, np, traverse, kind,
                                   recorder.calls[kind], smi,
                                   "phase7 routed='grid' frame")
           for kind in ("nearest", "anyhit")}
    del recorder
    forms = []
    for i, (_, wo, wd, wmin, wmax) in enumerate(shadows):
        args, _ = isect._args(wo, wd, wmin, wmax)
        a, b = isect._routed_anyhit_fused(args), grid._rounds_anyhit(args)
        check(f"phase7 shadow call {i} fused any-hit == per-round any-hit",
              bool((a == b).all()), f"({int((a != b).sum())} differ of {a.numel()})")
        ms_f = cuda_ms(torch, lambda: isect._routed_anyhit_fused(args))
        ms_g = cuda_ms(torch, lambda: grid._rounds_anyhit(args))
        forms.append({"fused_ms": ms_f, "per_round_ms": ms_g})
        print(f"phase7 shadow call {i}: {int((wmax > 0).sum())} live rays; fused "
              f"any-hit (1 launch) {ms_f:.3f} ms, per-round any-hit "
              f"({grid.n_domains} launches) {ms_g:.3f} ms; card {smi}", flush=True)
    return {"frame_s": frame, "warm_s": warm, "rays_traced": rays,
            "grays_per_sec": rays / frame / 1e9, "anyhit_forms": forms,
            "profile": prof}, kst, launches


def brute_kernel_stats(torch, np, tag, isect, calls, smi):
    """One frame's brute launches: every call timed against its bound, and
    BRUTE_SAMPLE_BLOCKS blocks of 256 rays of each held against the plain
    version.  The any-hit's bound counts the tests the serial order needs
    (brute.anyhit_serial_tests); the tests the kernel began (its counter)
    must equal them on every call.  Returns stats by kind."""
    from spray_tpu_torch.kernels import brute

    dev = isect.tri9.device
    n_tris = isect.tri9.shape[0]
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    keys = ("ms", "ops_ms", "bytes_ms", "s_ms", "s_plain_ms", "s_ops_ms",
            "s_bytes_ms", "s_err")
    st = {k: {**dict.fromkeys(keys, 0.0), "launches": 0, "s_rays": 0,
              "serial_tests": 0, "kernel_tests": 0}
          for k in ("nearest", "anyhit")}

    def parts(kind, rays):
        """Bound of one call: nearest tests every live ray against every
        triangle, any-hit the tests the serial order needs; bytes: the
        table, the rays, the outputs."""
        if kind == "nearest":
            tests = int((rays[3] > rays[2]).sum()) * n_tris
        else:
            tests = int(brute.anyhit_serial_tests(isect.tri9, isect.ids,
                                                  *rays).sum())
        n = rays[0].shape[0]
        nbytes = n_tris * 40 + n * (32 + (16 if kind == "nearest" else 4))
        return tests, tests * MT_OPS / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3

    for ci, (kind, *rays) in enumerate(calls):
        rays = tuple(x.contiguous() for x in rays)
        print(f"{tag} call {ci} {kind}: {rays[0].shape[0]} lanes, "
              f"{int((rays[3] > rays[2]).sum())} live", flush=True)
        # the kernels with the table the intersector packed once
        fn = functools.partial(brute.brute_nearest if kind == "nearest"
                               else brute.brute_anyhit, tri12=isect.tri12)
        plain = (brute.brute_nearest_reference if kind == "nearest"
                 else brute.brute_anyhit_reference)
        s = st[kind]
        _, ms = timed_once(torch, lambda: fn(isect.tri9, isect.ids, *rays))
        tests, ops_ms, bytes_ms = parts(kind, rays)
        if kind == "anyhit":
            counter.zero_()
            fn(isect.tri9, isect.ids, *rays, counter=counter)
            own = int(counter)
            check(f"{tag} call {ci} brute_anyhit_kernel began the tests the "
                  "serial order needs", own == tests,
                  f"({own} vs {tests})")
            s["serial_tests"] += tests
            s["kernel_tests"] += own
        s["ms"] += ms
        s["ops_ms"] += ops_ms
        s["bytes_ms"] += bytes_ms
        s["launches"] += 1
        n_blocks = rays[0].shape[0] // 256
        blocks = torch.linspace(0, n_blocks - 1, min(BRUTE_SAMPLE_BLOCKS, n_blocks),
                                device=dev).long()
        idx = (blocks[:, None] * 256 + torch.arange(256, device=dev)).view(-1)
        sub = tuple(x[idx].contiguous() for x in rays)
        got = fn(isect.tri9, isect.ids, *sub)
        ref, plain_ms = timed_once(torch,
                                   lambda: plain(isect.tri9, isect.ids, *sub))
        s["s_err"] = max(s["s_err"], compare_exact(
            f"{tag} call {ci} brute_{kind}_kernel on {idx.numel()} rays", ref, got))
        _, ops_ms, bytes_ms = parts(kind, sub)
        s["s_ms"] += cuda_ms(torch, lambda: fn(isect.tri9, isect.ids, *sub))
        s["s_plain_ms"] += plain_ms
        s["s_ops_ms"] += ops_ms
        s["s_bytes_ms"] += bytes_ms
        s["s_rays"] += idx.numel()
    for kind, s in st.items():
        fb, fby = bound_of(s["ops_ms"], s["bytes_ms"])
        sb, sby = bound_of(s["s_ops_ms"], s["s_bytes_ms"])
        s.update(frame_bound_ms=fb, frame_bound_by=fby, bound_ms=sb, bound_by=sby)
        own = (f"; tests the serial order needs {s['serial_tests']}, the "
               f"kernel began {s['kernel_tests']} (ratio "
               f"{s['kernel_tests'] / max(s['serial_tests'], 1):.4f})"
               if kind == "anyhit" else "")
        print(f"{tag} brute_{kind}_kernel: one frame {s['ms']:.3f} ms in "
              f"{s['launches']} launches against {n_tris} tris, bound {fb:.4f} ms "
              f"({fby}){own}; samples ({s['s_rays']} rays) {s['s_ms']:.3f} ms vs "
              f"plain {s['s_plain_ms']:.3f} ms, bound {sb:.4f} ms ({sby}), max "
              f"abs err {s['s_err']:.3g}; card {smi}", flush=True)
    return st


def check_brute_anyhit(torch, np, dev):
    """Constructed launches of brute_anyhit_kernel, each == its plain
    version bit for bit, with the expected flags and the kernel's own test
    count == brute.anyhit_serial_tests: every ray of two blocks occluded by
    row 0 (the block leaves after one tile); a hit only in the table's last
    tile; every lane dead (empty, inverted and NaN windows); rows with
    id < 0 in front of every ray between the hits.  The table: 3 full tiles
    and 17 rows, filler triangles far off the rays' paths; the rays look
    down -z from z = 3 near (0, 0)."""
    from spray_tpu_torch.kernels import brute

    n_tris, n = 3 * 256 + 17, 256
    rs = np.random.RandomState(17)
    filler = np.zeros((n_tris, 9), np.float32)
    filler[:, 0:3] = rs.uniform(30.0, 40.0, (n_tris, 3))
    filler[:, 3:9] = rs.uniform(-1.0, 1.0, (n_tris, 6))
    cover = np.float32([-2.0, -2.0, 0.0, 8.0, 0.0, 0.0, 0.0, 8.0, 0.0])
    o = np.concatenate([rs.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 3.0)],
                       axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    zeros, inf = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    dead_lo, dead_hi = zeros.copy(), zeros.copy()
    dead_hi[1::4] = -1.0
    dead_lo[2::4] = np.nan
    dead_hi[3::4] = np.nan

    def table(rows, neg=()):
        tri9, ids = filler.copy(), np.arange(n_tris, dtype=np.int32)
        for r in rows:
            tri9[r] = cover
        for r in neg:
            tri9[r] = cover
            tri9[r, 2] = 1.0  # nearer than the real rows
            ids[r] = -1
        return tri9, ids

    half = np.arange(n) < n // 2
    neg = [0, 1, 255, 256, 600, n_tris - 1]
    cases = [  # (name, table, tmin, tmax, expected flags)
        ("every ray occluded by row 0", table([0]), zeros, inf, np.ones(n)),
        ("a hit only in the last tile", table([n_tris - 1]), zeros, inf,
         np.ones(n)),
        ("every lane dead", table([0, 7]), dead_lo, dead_hi, np.zeros(n)),
        ("rows with id < 0 between the hits", table([700], neg), zeros,
         np.where(half, np.inf, 2.5).astype(np.float32), half),
    ]
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    for name, (tri9, ids), lo, hi, want in cases:
        args = [torch.as_tensor(x, device=dev) for x in (tri9, ids, o, d, lo, hi)]
        tri12 = brute.pack_table(args[0], args[1])
        counter.zero_()
        got = brute.brute_anyhit(*args, tri12=tri12, counter=counter)
        torch.cuda.synchronize()
        ref = brute.brute_anyhit_reference(*args)
        compare_exact(f"phase7 constructed brute_anyhit_kernel launch, {name}",
                      ref, got)
        check(f"phase7 constructed brute launch, {name}: the expected flags",
              bool((got.cpu().numpy() == want).all()), f"({int(want.sum())} of {n})")
        serial = int(brute.anyhit_serial_tests(*args).sum())
        check(f"phase7 constructed brute launch, {name}: kernel tests == "
              "serial tests", int(counter) == serial, f"({int(counter)} vs {serial})")


def phase7_brute(torch, np, tag, scene, cam, cfg, dev, smi):
    """A 512x512 spp-4 frame through PallasBruteIntersector on a small
    scene.  Returns (numbers, brute-kernel stats by kind, launch counts)."""
    from spray_tpu_torch.kernels.brute import PallasBruteIntersector
    from spray_tpu_torch.render import default_intersector, make_pipeline

    tag = f"phase7 brute {tag}"
    isect = PallasBruteIntersector(scene, device=dev)
    pipe = make_pipeline(scene, cam, cfg, backward=False, intersector=isect,
                         device=dev)
    warm, times, out = timed_frames(torch, pipe.run, ALT_TIMED)
    launches = read_launches()
    frame, rays = min(times), pipe.rays_traced(out)
    prof = profile_top(torch, f"{tag} forward frame", pipe.run)
    base = default_intersector(scene, device=dev)
    ref = make_pipeline(scene, cam, cfg, backward=False, intersector=base,
                        device=dev).run()[0]
    print(f"{tag}: {scene.num_faces} tris; frame times "
          f"{[round(t, 4) for t in times]} s; min {frame:.4f} s (warm-up "
          f"{warm:.2f} s); rays_traced {rays}; {rays / frame / 1e9:.6f} Grays/s; "
          f"launches over {ALT_TIMED} frames {launches}; card {smi}", flush=True)
    n_px = image_close(f"{tag} image ~ {type(base).__name__}'s", out[0], ref, np,
                       ref[..., 0].numel() // TIE_PIXELS)
    check(f"{tag} image finite and nonzero", bool(torch.isfinite(out[0]).all())
          and float(out[0].mean()) > 0, f"(mean {float(out[0].mean()):.6f})")
    for k in ("brute_nearest_kernel", "brute_anyhit_kernel"):
        check(f"{tag} {k} launched on the path", launches[k] > 0, f"({launches[k]})")
    rec = Recorder(isect)
    make_pipeline(scene, cam, cfg, backward=False, intersector=rec,
                  device=dev).run()
    kst = brute_kernel_stats(torch, np, tag, isect, rec.calls, smi)
    return ({"tris": scene.num_faces, "frame_s": frame, "warm_s": warm,
             "rays_traced": rays, "grays_per_sec": rays / frame / 1e9,
             "pixels_outside": n_px, "profile": prof}, kst, launches)


PHASE8_TIMED = 2  # timed steps and frames of each phase-8 path, after a warm-up
PHASE8_SAMPLE_CALLS = 4  # per-page calls of each in-situ kernel held against plain
GATE_BUCKETS = (1 << 14, 4096)  # tests_tpu/insitu_gate.py's bucket, and overflow


def max_diff(np, a, b):
    a, b = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x) for x in (a, b))
    return float(np.abs(a - b).max())


def phase8_rayshard(torch, np, mesh, scene, cam, cfg, train_ref, smi):
    """(a) make_sharded_render_grad at the bench configuration, with
    default_intersector, against phase 6's training step."""
    from spray_tpu_torch import dist as sdist
    from spray_tpu_torch.dist import rayshard
    from spray_tpu_torch.render import default_intersector

    dev = mesh.device
    t0 = time.perf_counter()
    step = rayshard.make_sharded_render_grad(
        scene, cam, cfg, mesh, make_intersector=lambda s: default_intersector(
            s, device=dev))
    build = time.perf_counter() - t0
    ids, _ = rayshard.padded_pixel_ids(cam, mesh.size)
    params = {k: torch.as_tensor(np.asarray(getattr(scene, k), np.float32),
                                 device=dev) for k in ("vertices", "albedo")}
    def run():
        out = step(params, ids)
        torch.cuda.synchronize()
        return out

    _, times, (_, loss, grads) = timed_frames(torch, run, PHASE8_TIMED)
    launches, coll = read_launches(), dict(sdist.collectives)
    steps = PHASE8_TIMED
    print(f"phase8 rayshard: {mesh.size} rank(s), {torch.distributed.get_backend()}"
          f"; intersector built in "
          f"{build:.2f} s; step times {[round(t, 4) for t in times]} s; min "
          f"{min(times):.4f} s vs phase 6's {train_ref['step_s']:.4f} s; over "
          f"{steps} steps: launches {launches}, collectives {coll} "
          f"({coll['all_reduce'] / steps:g} all_reduce a step); card {smi}",
          flush=True)
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"phase8 rayshard {k} launched on the path", launches[k] > 0,
              f"({launches[k]})")
    check("phase8 rayshard: one all_reduce a gradient tensor and one for the "
          "loss", coll["all_reduce"] == steps * (len(params) + 1), f"({coll})")
    lr = train_ref["loss"]
    check("phase8 rayshard loss ~ phase 6's (rtol 1e-5, atol 1e-7)",
          abs(float(loss) - lr) <= 1e-7 + 1e-5 * abs(lr),
          f"({float(loss):.8f} vs {lr:.8f})")
    for k, g in grads.items():
        ref = train_ref["grads"][k]
        got = g.cpu().numpy()
        bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-7)
        check(f"phase8 rayshard {k} gradients ~ phase 6's (rtol 1e-4, atol 1e-7)",
              not bad.any() and np.isfinite(got).all(),
              f"({int(bad.sum())} of {got.size} outside, max abs diff "
              f"{float(np.abs(got - ref).max()):.3g}, max |g| "
              f"{float(np.abs(ref).max()):.4g})")
    return {"step_s": min(times), "times": times, "intersector_build_s": build,
            "loss": float(loss), "collectives_per_step": {
                k: v / steps for k, v in coll.items()},
            "launches_per_step": {k: v / steps for k, v in launches.items()}}, launches


def insitu_vs_fast(torch, np, tag, mesh, scene, cam, cfg, bucket, smi,
                   fast_isect, timed=1):
    """make_insitu_renderer at (n_domains 8, bucket) against the fast path's
    frame through fast_isect (max abs diff <= 1e-4, the bar of
    tests_tpu/insitu_gate.py): `timed` frames of each after a warm-up, the
    in-situ frame's launches, syncs and collectives per frame.  Returns
    (numbers, the renderer, launches of one frame)."""
    from spray_tpu_torch import dist as sdist
    from spray_tpu_torch.dist.epochs import make_insitu_renderer
    from spray_tpu_torch.integrators.device import make_render_fn
    from spray_tpu_torch.integrators.wavefront import make_scene_arrays

    dev = mesh.device
    t0 = time.perf_counter()
    render = make_insitu_renderer(scene, cam, cfg, mesh, n_domains=8,
                                  bucket=bucket)
    setup = time.perf_counter() - t0
    fn = make_render_fn(scene, cam, cfg, fast_isect, device=dev)
    arrays = make_scene_arrays(scene, dev)

    def fast():
        return fn(arrays).cpu().numpy()

    _, t_in, img = timed_frames(torch, render, timed)
    launches = {k: v // timed for k, v in read_launches().items()}
    coll = {k: v // timed for k, v in sdist.collectives.items()}
    stats = dict(render.last_stats)
    _, t_fast, ref = timed_frames(torch, fast, timed)
    out = {"bucket": bucket, "setup_s": setup, "last_stats": stats,
           "collectives": coll, "launches": launches, "insitu_s": min(t_in),
           "fast_s": min(t_fast), "ratio": min(t_in) / min(t_fast),
           "insitu_times": t_in, "fast_times": t_fast}
    diff = max_diff(np, img, ref)
    out["max_abs_diff"] = diff
    print(f"{tag}: in-situ bucket {bucket}, setup {setup:.2f} s; last_stats "
          f"{stats}; one frame: {coll['host_syncs']} host syncs, collectives "
          f"{ {k: v for k, v in coll.items() if k != 'host_syncs'} }, launches "
          f"{launches}; frame {out['insitu_s']:.4f} s (times "
          f"{[round(t, 4) for t in t_in]}) vs fast path {out['fast_s']:.4f} s "
          f"({[round(t, 4) for t in t_fast]}), ratio {out['ratio']:.3f}; max "
          f"abs diff {diff:.3g}; card {smi}", flush=True)
    check(f"{tag} in-situ image ~ fast path (max abs diff <= 1e-4)",
          diff <= 1e-4 and bool(np.isfinite(img).all()) and img.mean() > 0,
          f"({diff:.3g}; mean {img.mean():.6f} vs {ref.mean():.6f})")
    for k in ("nearest_slot_kernel", "anyhit_kernel"):
        check(f"{tag} {k} launched on the in-situ path", launches[k] > 0,
              f"({launches[k]})")
    return out, render, launches


def phase8_insitu(torch, np, mesh, scene, cam, smi):
    """(b) the in-situ frame at full width against the fast path, and (d)
    sampled per-page calls of its two kernels against their plain
    versions (the slot kernel also against walk_reference)."""
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.kernels import traverse
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    cfg1 = RenderConfig(width=512, height=512, spp=1, bounces=2,
                        integrator="pt", nee=True, seed=0)
    t0 = time.perf_counter()
    fast8 = MultiDomainClusterIntersector(scene, n_domains=8, device=mesh.device)
    print(f"phase8 in-situ: fast-path intersector, 8 domains, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    bucket = cam.width * cam.height // mesh.size
    out, render, launches = insitu_vs_fast(
        torch, np, "phase8 in-situ 512x512", mesh, scene, cam, cfg1, bucket, smi,
        fast8, timed=PHASE8_TIMED)
    out["profile"] = profile_top(torch, "phase8 in-situ 512x512 frame", render)
    del fast8
    with SlotRecorder(traverse) as recorder:
        render()
    st = {kind: slot_kernel_stats(torch, np, traverse, kind,
                                  recorder.calls[kind], smi,
                                  "phase8 in-situ frame",
                                  n_calls=PHASE8_SAMPLE_CALLS)
          for kind in ("nearest", "anyhit")}
    del recorder, render
    return out, st, launches


def phase8_gate(torch, np, mesh, smi):
    """(c) tests_tpu/insitu_gate.py's configuration at its bucket and at a
    bucket that overflows, against the fast path, and the in-situ
    differentiable step against make_diff_render_fn."""
    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.diff import make_diff_render_fn
    from spray_tpu_torch.dist.epochs import make_insitu_diff_fn
    from spray_tpu_torch.io.scenes import wisp_cloud
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    dev = mesh.device
    scene = wisp_cloud(n_blobs=8, tris_per_blob=16384, seed=3)
    cam = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                      fov_y_deg=45, width=128, height=128)
    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=0)
    fast8 = MultiDomainClusterIntersector(scene, n_domains=8, device=dev)
    gate = {}
    for bucket in GATE_BUCKETS:
        gate[bucket], _, _ = insitu_vs_fast(
            torch, np, f"phase8 gate 128x128 bucket {bucket}", mesh, scene, cam,
            cfg, bucket, smi, fast8)
    e0, e1 = (gate[b]["last_stats"]["epochs"] for b in GATE_BUCKETS)
    check(f"phase8 gate: bucket {GATE_BUCKETS[1]} overflows into more epochs",
          e1 > e0, f"({e1} vs {e0})")
    step = make_insitu_diff_fn(scene, cam, cfg, mesh, n_domains=8, bucket=GATE_BUCKETS[0])
    params = {k: torch.as_tensor(np.asarray(getattr(scene, k), np.float32),
                                 device=dev) for k in ("vertices", "albedo")}
    loss_d, grads_d = step(params)
    render = make_diff_render_fn(scene, cam, cfg, make_intersector=lambda s: fast8,
                                 device=dev)
    w = torch.tensor([0.4, 0.8, 1.3], device=dev)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss_r = torch.mean(render(p) * w)
    grads_r = dict(zip(p, torch.autograd.grad(loss_r, list(p.values()))))
    lr = float(loss_r.detach())
    check("phase8 gate in-situ diff loss ~ make_diff_render_fn's (rtol 1e-5)",
          abs(float(loss_d) - lr) <= 1e-5 * abs(lr), f"({float(loss_d):.8f} vs {lr:.8f})")
    for k in params:
        gd, gr = grads_d[k].cpu().numpy(), grads_r[k].cpu().numpy()
        scale = float(np.abs(gr).max())
        bad = ~np.isclose(gd, gr, rtol=1e-4, atol=1e-5 * scale)
        check(f"phase8 gate in-situ diff {k} gradients ~ make_diff_render_fn's "
              "(atol 1e-5 of the largest, rtol 1e-4)",
              scale > 0 and not bad.any() and np.isfinite(gd).all(),
              f"({int(bad.sum())} of {gd.size} outside, max abs diff "
              f"{float(np.abs(gd - gr).max()):.3g}, max |g| {scale:.4g})")
    gate["diff_loss"] = float(loss_d)
    return gate


def phase8_rank(rank, world_size, smi, train_ref):
    """Phase 8 in one rank of a NCCL world: the distributed paths on the
    card.  Returns its numbers, its failed checks and the in-situ kernels'
    stats."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.dist.rayshard import make_mesh
    from spray_tpu_torch.io.scenes import wisp_cloud

    mesh = make_mesh(world_size)
    check("phase8 the world is a NCCL group on the card",
          dist.get_backend() == "nccl" and mesh.device.type == "cuda",
          f"({dist.get_backend()}, {mesh.device}, {mesh.size} rank(s))")
    scene = wisp_cloud(n_blobs=8, tris_per_blob=131072, seed=3)
    cam = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                      fov_y_deg=45, width=512, height=512)
    cfg = RenderConfig(width=512, height=512, spp=4, bounces=2,
                       integrator="pt", nee=True, seed=0)
    rayshard, rs_launches = phase8_rayshard(torch, np, mesh, scene, cam, cfg,
                                            train_ref, smi)
    phase_done("phase8 (a) rayshard")
    insitu, st, in_launches = phase8_insitu(torch, np, mesh, scene, cam, smi)
    phase_done("phase8 (b, d) in-situ")
    del scene
    gate = phase8_gate(torch, np, mesh, smi)
    phase_done("phase8 (c) gate")
    return {"failed": list(FAILED), "rayshard": rayshard, "insitu": insitu,
            "gate": gate, "stats": st,
            "launches": {"rayshard": rs_launches, "insitu": in_launches}}


BENCH_REF = ROOT / "BENCH_r05.json"  # the reference's last bench line (a TPU run)
FIT_STEPS = 4  # steps of phase 9's fit, with a checkpoint at half of them
FIT_LR = 0.02  # Adam's rate there: the loss falls at every one of the steps
FIT_RTOL = 1e-3  # each card loss against fit(device="cpu")'s, relative


def phase9_native(np, scene, pages, rays):
    """(a) The native builder: the library loads (a missing one fails the
    run), and the bench scene's pages built with it equal the pages the
    numpy fallback builds, and phase 4's, bit for bit; each build timed."""
    from spray_tpu_torch import native
    from spray_tpu_torch.kernels.multidomain import build_cluster_domains

    lib = native.get_lib()
    check("phase9 (a) native library built and loaded", lib is not None,
          f"({getattr(lib, '_name', None)})")
    built, secs = {}, {}
    saved = native._loaded.get("lib")
    for tag, loaded in (("native", saved), ("fallback", None)):
        native._loaded["lib"] = loaded  # None: as on a host with no g++
        try:
            t0 = time.perf_counter()
            built[tag] = build_cluster_domains(scene)
            secs[tag] = time.perf_counter() - t0
        finally:
            native._loaded["lib"] = saved
    for tag in ("native", "fallback"):
        got = built[tag]
        same = got.keys() == pages.keys() and all(
            np.asarray(got[k]).dtype == np.asarray(pages[k]).dtype
            and np.asarray(got[k]).tobytes() == np.asarray(pages[k]).tobytes()
            for k in pages)
        check(f"phase9 (a) bench pages built with the {tag} path == phase 4's, "
              "bit for bit", same)
    ref = (json.loads(BENCH_REF.read_text())["parsed"]["detail"]["rays_per_frame"]
           if BENCH_REF.exists() else None)
    print(f"phase9 (a): bench pages built in {secs['native']:.2f} s with the "
          f"native library, {secs['fallback']:.2f} s with the numpy fallback; "
          f"phase 4 rays_traced {rays} beside {BENCH_REF.name}'s {ref} (a "
          "record, not a check)", flush=True)
    return {"pages_native_s": secs["native"], "pages_fallback_s": secs["fallback"],
            "rays_traced": rays, "bench_r05_rays": ref}


def run_cli(args):
    """spray_tpu_torch.cli.main(args) in this process, launch counts set to
    0 just before and read just after.  Returns (its printed text, launch
    counts, seconds)."""
    import contextlib
    import io

    from spray_tpu_torch import cli

    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    secs = time.perf_counter() - t0
    return buf.getvalue(), read_launches(), secs


def phase9_cli(tmp, smi):
    """(b) The CLI render app in-process: one-shot on the builtin wisp scene
    at the CLI's defaults, then the ooc and baseline schedulers at 256x256,
    spp 1 (byte-identical images), and inspect."""
    out, res = {}, {}
    runs = (("one_shot", [], ("nearest_kernel", "anyhit_kernel")),
            ("ooc", ["--scheduler", "ooc", "--size", "256", "--spp", "1"],
             ("nearest_slot_kernel", "anyhit_kernel")),
            ("baseline", ["--scheduler", "baseline", "--domains", "16",
                          "--slots", "4", "--size", "256", "--spp", "1"],
             ("nearest_slot_kernel", "anyhit_kernel")))
    for tag, extra, kernels in runs:
        out[tag] = Path(tmp) / f"{tag}.ppm"
        text, launches, secs = run_cli(["render", "--builtin", "wisp", "-o",
                                        str(out[tag]), *extra])
        stats = json.loads(text.strip().splitlines()[-1])
        print(f"phase9 (b) cli render {tag}: {json.dumps(stats)}; launches "
              f"{launches}; {secs:.2f} s in all (scene and pages included); "
              f"card {smi}", flush=True)
        check(f"phase9 (b) cli {tag}: image written, backend cuda",
              out[tag].exists() and stats["backend"] == "cuda", f"({stats['output']})")
        for k in kernels:
            check(f"phase9 (b) cli {tag}: {k} launched", launches[k] > 0,
                  f"({launches[k]})")
        if tag != "one_shot":
            check(f"phase9 (b) cli {tag}: epochs > 0", stats["epochs"] > 0,
                  f"({stats['epochs']})")
        res[tag] = {"stats": stats, "launches": launches, "cli_s": secs}
    check("phase9 (b) cli ooc and baseline images byte-identical",
          out["ooc"].read_bytes() == out["baseline"].read_bytes())
    text, _, _ = run_cli(["inspect", "--builtin", "wisp"])
    info = json.loads(text)
    print(f"phase9 (b) cli inspect: {json.dumps(info)}", flush=True)
    check("phase9 (b) cli inspect: triangles == the render's scene",
          info["triangles"] == res["one_shot"]["stats"]["scene_tris"],
          f"({info['triangles']})")
    return res


def phase9_fit(torch, np, scene, tmp, dev):
    """(c) fit on the wisp scene at 128x128 with the card's
    default_intersector: FIT_STEPS steps in one run, the loss falling at
    every step; the same steps with fit(device="cpu") on the same inputs
    (the CPU's default intersector), each loss within FIT_RTOL of the
    card's; and the card's run cut at a checkpoint and resumed, the
    resumed losses equal to the uninterrupted ones bit for bit."""
    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.diff import make_diff_render_fn
    from spray_tpu_torch.optim import fit
    from spray_tpu_torch.render import default_intersector

    isect = default_intersector(scene, device=dev)
    cpu_isect = default_intersector(scene, device="cpu")
    cam = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                      fov_y_deg=45, width=128, height=128)
    cfg = RenderConfig(spp=1, bounces=2, integrator="pt", seed=3)
    albedo = torch.as_tensor(scene.albedo, device=dev)
    target = make_diff_render_fn(scene, cam, cfg, lambda _: isect,
                                 device=dev)({"albedo": albedo}).detach()
    start = {"albedo": scene.albedo * 0.4 + 0.2}
    kw = dict(lr=FIT_LR, make_intersector=lambda _: isect, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    _, losses = fit(scene, cam, cfg, target, start, steps=FIT_STEPS, **kw)
    secs = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    _, cpu_losses = fit(scene, cam, cfg, target.cpu(), start, steps=FIT_STEPS,
                        lr=FIT_LR, make_intersector=lambda _: cpu_isect,
                        device="cpu")
    cpu_secs = time.perf_counter() - t0
    ckpt = str(Path(tmp) / "fit.npz")
    half = FIT_STEPS // 2
    _, first = fit(scene, cam, cfg, target, start, steps=half,
                   checkpoint_path=ckpt, checkpoint_every=half, **kw)
    _, resumed = fit(scene, cam, cfg, target, start, steps=FIT_STEPS,
                     checkpoint_path=ckpt, checkpoint_every=FIT_STEPS + 1, **kw)
    rel = [abs(a - b) / b for a, b in zip(losses, cpu_losses)]
    print(f"phase9 (c) fit: {type(isect).__name__}, {scene.num_faces} tris, "
          f"128x128, lr {FIT_LR}: losses {losses} in {secs:.2f} s; on the CPU "
          f"({type(cpu_isect).__name__}) {cpu_losses} in {cpu_secs:.2f} s, "
          f"relative differences {rel}; first {half} steps {first}, resumed "
          f"{resumed}; launches {launches}", flush=True)
    check(f"phase9 (c) fit: resumed steps {half + 1}-{FIT_STEPS} equal the "
          "uninterrupted run's bit for bit",
          first + resumed == losses, f"({first + resumed} vs {losses})")
    check("phase9 (c) fit: the loss falls at every step",
          all(b < a for a, b in zip(losses, losses[1:])), f"({losses})")
    check(f"phase9 (c) fit: each loss within {FIT_RTOL} (relative) of "
          "fit(device='cpu')'s", len(rel) == FIT_STEPS and max(rel) <= FIT_RTOL,
          f"(largest {max(rel):.3g})")
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"phase9 (c) fit: {k} launched", launches[k] > 0, f"({launches[k]})")
    return {"losses": losses, "cpu_losses": cpu_losses, "rel_diff": rel,
            "fit_s": secs, "cpu_fit_s": cpu_secs, "launches": launches}


def phase9_viewer(torch, np, scene, dev):
    """(d) InteractiveViewer on the card: two frames and an orbit at 64x64."""
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.viewer import InteractiveViewer

    v = InteractiveViewer(scene, RenderConfig(spp=1, bounces=2, integrator="pt"),
                          size=64, device=dev)
    reset_launches()
    img1, img2 = v.frame(), v.frame()
    v.orbit(dtheta=0.3)
    img3 = v.frame()
    launches = read_launches()
    ok = all(i.shape == (64, 64, 3) and np.isfinite(i).all()
             for i in (img1, img2, img3))
    print(f"phase9 (d) viewer: means {img1.mean():.6f} {img2.mean():.6f} "
          f"{img3.mean():.6f}; launches {launches}", flush=True)
    check("phase9 (d) viewer: frames finite, 64x64, the orbit moved the camera",
          ok and not np.allclose(img1, img3))
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"phase9 (d) viewer: {k} launched", launches[k] > 0, f"({launches[k]})")
    return {"launches": launches}


def run_script(cmd, timeout):
    """A script of the checkout run as its own process; returns
    (exit code, its stdout, seconds).  Its progress lines (stderr lines
    that start with '# ') are printed; so is its stderr's tail when it
    fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    for ln in proc.stderr.splitlines():
        if ln.startswith("# "):
            print(f"{cmd[0]} {ln}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


SUITE_REF = ROOT / "BENCH_extra.json"  # the reference's suite (a TPU run)
SUITE_OUT = ROOT / "build" / "BENCH_extra_torch.json"


def suite_keys():
    """{row: the keys bench.py's suite writes there} (bench_torch.ROW_KEYS,
    which tests/test_torch_bench_suite.py holds to bench.py's), the keys of
    profiling/scaling_curve.py's rows (BENCH_extra.json's) and that file."""
    from bench_torch import ROW_KEYS, SUITE_VARIANTS

    ref = json.loads(SUITE_REF.read_text())
    rows = {v[0]: set(ROW_KEYS[v[0].split("_")[0]]) for v in SUITE_VARIANTS}
    return rows, set(ref["scaling_cpu_mesh"]["1"]), ref


def check_suite(extra, smi):
    """(e) The suite's JSON: the reference's rows and keys, its counters
    beside BENCH_extra.json's (read-only: that file's times are the TPU's),
    the scheduler's invariants and the lookahead open above the gate's
    threshold (sched/epochs.py's PROBE_MB_S)."""
    from spray_tpu_torch.sched.epochs import PROBE_MB_S

    rows, curve_keys, ref = suite_keys()
    for name, keys in rows.items():
        got = extra.get(name)
        check(f"phase9 (e) suite row {name} has bench.py's keys",
              got is not None and set(got) == keys,
              f"({sorted(got) if got else None})")
        if got is None:
            continue
        pairs = ", ".join(f"{k} {got[k]} (TPU {ref[name][k]})"
                          for k in ref[name] if k not in ("frame_s", "warm_s",
                                                          "grays_per_sec"))
        launches = extra.get("launches", {}).get(name, {})
        print(f"phase9 (e) suite {name}: frame {got['frame_s']:.4f} s, warm-up "
              f"{got['warm_s']:.3f} s; {pairs}"
              + (f"; lookahead {got['lookahead_active']}, probe "
                 f"{got['host_to_hbm_mbps']} MB/s" if "prefetches" in got else "")
              + f"; launches a frame {launches}; card {smi}", flush=True)
        eff = got["speculation_efficiency"]
        check(f"phase9 (e) suite {name}: 0 < speculation_efficiency <= 1",
              0 < eff <= 1, f"({eff})")
        for k in ("nearest_slot_kernel", "anyhit_kernel"):
            check(f"phase9 (e) suite {name}: {k} launched", launches.get(k, 0) > 0,
                  f"({launches.get(k)} a frame)")
    c3 = [extra[k]["committed"] for k in rows
          if k.startswith("config3") and k in extra]
    check("phase9 (e) suite: committed equal in the three config-3 rows",
          len(c3) == 3 and len(set(c3)) == 1, f"({c3})")
    base = extra.get("config3_baseline", {})
    check("phase9 (e) suite: config3_baseline speculated nothing",
          base.get("speculated") == 0, f"({base.get('speculated')})")
    pre = extra.get("config4_prefetch", {})
    mbps = pre.get("host_to_hbm_mbps")
    check(f"phase9 (e) suite: config4_prefetch lookahead on (probe above "
          f"{PROBE_MB_S:g} MB/s)", pre.get("lookahead_active") is True
          and mbps is not None and mbps > PROBE_MB_S,
          f"({pre.get('lookahead_active')}, {mbps} MB/s, "
          f"{pre.get('prefetches')} prefetches)")
    curve = extra.get("scaling_cpu_mesh") or {}
    check("phase9 (e) suite: the curve has rows", bool(curve), f"({list(curve)})")
    for n, row in curve.items():
        times = [v for k, v in row.items() if k.endswith("_s")]
        check(f"phase9 (e) curve world {n}: scaling_curve.py's keys, times > 0",
              set(row) == curve_keys and len(times) == 4
              and all(t > 0 for t in times), f"({row})")
        print(f"phase9 (e) curve world {n} (gloo CPU ranks on the card's host): "
              f"{row}", flush=True)
    print(f"phase9 (e) suite {extra.get('suite_s', 0):.1f} s, curve "
          f"{extra.get('curve_s', 0):.1f} s; suite card: {extra.get('card')}",
          flush=True)


def phase9_bench_and_gate(train_rays, smi):
    """(e) bench_torch.py --iters 2 --suite, (f) tests_gpu/parity_gate.py and
    (g) tests_gpu/insitu_gate.py, each as its own process."""
    SUITE_OUT.unlink(missing_ok=True)
    rc, out, secs = run_script(["bench_torch.py", "--iters", "2", "--suite"], 900)
    lines = out.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        line = None
    check("phase9 (e) bench_torch.py --suite exits 0 and prints one JSON line",
          rc == 0 and line is not None and len(lines) == 1,
          f"(exit {rc}, {len(lines)} lines)")
    bench = {"bench_s": secs}
    if line is not None:
        d = line["detail"]
        print(f"phase9 (e) bench_torch.py: frame {d['frame_s']:.4f} s, "
              f"{line['value']:.6f} Grays/s fwd+bwd, rays_per_frame "
              f"{d['rays_per_frame']}, card {d['card']}; suite {d.get('suite')}; "
              f"{secs:.1f} s in all with the suite and the curve", flush=True)
        print(json.dumps(line), flush=True)
        check("phase9 (e) bench_torch.py rays_per_frame == phase 6's rays_traced",
              d["rays_per_frame"] == train_rays,
              f"({d['rays_per_frame']} vs {train_rays})")
        bench.update(line)
    extra = json.loads(SUITE_OUT.read_text()) if SUITE_OUT.exists() else {}
    check(f"phase9 (e) {SUITE_OUT.relative_to(ROOT)} written", bool(extra))
    if extra:
        check_suite(extra, smi)
    bench["suite"] = extra
    rc, out, secs = run_script(["tests_gpu/parity_gate.py"], 600)
    gate = [ln for ln in out.splitlines() if ln.startswith("PARITY_GATE ")]
    print(f"phase9 (f) {gate[-1] if gate else 'no PARITY_GATE line'}; exit {rc}; "
          f"{secs:.1f} s; card {smi}", flush=True)
    check("phase9 (f) tests_gpu/parity_gate.py exits 0", rc == 0 and bool(gate),
          f"(exit {rc})")
    rc, out, secs = run_script(["tests_gpu/insitu_gate.py"], 600)
    ins = [ln for ln in out.splitlines() if ln.startswith("INSITU_GATE ")]
    insitu = json.loads(ins[-1].split(" ", 1)[1]) if ins else None
    print(f"phase9 (g) {ins[-1] if ins else 'no INSITU_GATE line'}; exit {rc}; "
          f"{secs:.1f} s; card {smi}", flush=True)
    check("phase9 (g) tests_gpu/insitu_gate.py exits 0 (image within 1e-4, "
          "within 3x of the fast path)", rc == 0 and insitu is not None
          and insitu["ok"], f"(exit {rc})")
    if insitu is not None:
        insitu["gate_s"] = secs
    return bench, (json.loads(gate[-1].split(" ", 1)[1]) if gate else None), insitu


PHASE10_TIMED = 3  # fenced frames of each phase-10 form, the least taken
SPP_RTOL = 1e-6  # per-sample against batched image: the reference test's bar


def spp_frames(torch, tag, fn, arrays):
    """PHASE10_TIMED fenced frames of `fn` after a warm-up, with the launch
    counts set to 0 just before and read just after: (image, numbers)."""
    fn(arrays)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(PHASE10_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = fn(arrays)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: frame times {[round(t, 4) for t in times]} s, min "
          f"{min(times):.4f} s; rays_traced {int(rays)}; peak memory "
          f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB allocated before); launches a frame "
          f"nearest_kernel {launches['nearest_kernel'] / PHASE10_TIMED:g}, "
          f"anyhit_kernel {launches['anyhit_kernel'] / PHASE10_TIMED:g}",
          flush=True)
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"{tag}: {k} launched", launches[k] > 0,
              f"({launches[k]} in {PHASE10_TIMED} frames)")
    return img, {"frame_s": min(times), "frame_times_s": times,
                 "rays_traced": int(rays), "peak_gib": peak / 2**30,
                 "allocated_before_gib": base / 2**30,
                 "frame_peak_bytes": peak - base, "launches": launches,
                 "timed_frames": PHASE10_TIMED}


def phase10_spp(torch, np, scene, pages, cam, cfg, dev, smi):
    """make_render_fn's choice of form, on the bench frame through the
    default multi-domain intersector.  (a) With the card's free memory the
    default takes the batched form; its peak above what was allocated
    before the frame stays within RAY_BYTES a ray.  (b) With a ballast
    tensor leaving free half of what the batched wavefront needs, the
    default takes the per-sample form, which renders there: image within
    SPP_RTOL of (a)'s, rays_traced equal.  (c) One per-sample frame's
    nearest and any-hit calls (once per sample) through main_call_stats,
    the last sample's calls held against the plain versions and
    walk_reference.  Frame time, peak memory and launches of each form."""
    from spray_tpu_torch.core.device import free_bytes
    from spray_tpu_torch.integrators import device as tdev
    from spray_tpu_torch.integrators.wavefront import make_scene_arrays
    from spray_tpu_torch.kernels import traverse
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    isect = MultiDomainClusterIntersector.from_pages(scene, pages, device=dev)
    arrays = make_scene_arrays(scene, dev)
    npix = cam.width * cam.height
    rays_batched = npix * cfg.spp
    need = rays_batched * tdev.RAY_BYTES
    out, imgs = {"card": smi, "routed": isect.routed}, {}
    torch.cuda.synchronize()
    free = free_bytes(dev)
    crossover = free // (npix * tdev.RAY_BYTES)
    print(f"phase10 (a) free memory {free / 2**30:.3f} GiB: the batched form "
          f"fits up to {free // tdev.RAY_BYTES} rays at {tdev.RAY_BYTES} B a "
          f"ray, spp {crossover} at {cam.width}x{cam.height}; card {smi}",
          flush=True)
    fn = tdev.make_render_fn(scene, cam, cfg, isect, with_stats=True, device=dev)
    check(f"phase10 (a) the default takes the batched form with "
          f"{free / 2**30:.3f} GiB free", fn.spp_batch is True,
          f"(needs {need / 2**30:.3f} GiB)")
    imgs["batched"], out["batched"] = spp_frames(
        torch, "phase10 (a) batched form (chosen)", fn, arrays)
    per_ray = out["batched"]["frame_peak_bytes"] / rays_batched
    check(f"phase10 (a) batched peak within RAY_BYTES a ray",
          per_ray <= tdev.RAY_BYTES,
          f"({per_ray:.1f} B a ray against {tdev.RAY_BYTES})")
    out.update(free_gib=free / 2**30, ray_bytes=tdev.RAY_BYTES,
               batched_bytes_a_ray=per_ray, crossover_spp=int(crossover))
    del fn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # hand the allocator's unused blocks back to CUDA
    ballast = torch.empty(max(free_bytes(dev) - need // 2, 0),
                          dtype=torch.uint8, device=dev)
    left = free_bytes(dev)
    fn = tdev.make_render_fn(scene, cam, cfg, isect, with_stats=True, device=dev)
    check(f"phase10 (b) the default takes the per-sample form with "
          f"{left / 2**30:.3f} GiB free", fn.spp_batch is False,
          f"(the batched form needs {need / 2**30:.3f} GiB)")
    imgs["per_sample"], out["per_sample"] = spp_frames(
        torch, f"phase10 (b) per-sample form (chosen, {left / 2**30:.3f} GiB "
        "free)", fn, arrays)
    out["per_sample"]["free_gib"] = left / 2**30
    del fn, ballast
    torch.cuda.empty_cache()

    a, b = imgs["batched"], imgs["per_sample"]
    far = ~torch.isclose(b, a, atol=SPP_RTOL, rtol=SPP_RTOL)
    check(f"phase10 (b) per-sample image ~ batched image (atol {SPP_RTOL}, "
          f"rtol {SPP_RTOL})", not bool(far.any()),
          f"(max abs {float((a - b).abs().max()):.3g}, "
          f"{int(far.any(dim=2).sum())} pixels outside, mean "
          f"{float(b.mean()):.6f})")
    check("phase10 (b) per-sample rays_traced == batched",
          out["per_sample"]["rays_traced"] == out["batched"]["rays_traced"],
          f"({out['per_sample']['rays_traced']} vs "
          f"{out['batched']['rays_traced']})")
    check("phase10 (b) images finite and nonzero",
          bool(torch.isfinite(b).all()) and float(b.mean()) > 0)
    del imgs, a, b

    # the recorded inputs outgrow the ballast: the per-sample form is
    # picked by reporting no free memory instead
    rec = Recorder(isect)
    saved, tdev.free_bytes = tdev.free_bytes, lambda device: 0
    fn = tdev.make_render_fn(scene, cam, cfg, rec, device=dev)
    tdev.free_bytes = saved
    check("phase10 (c) with no free memory reported, the per-sample form",
          fn.spp_batch is False)
    fn(arrays)
    torch.cuda.synchronize()
    del fn
    per = len(rec.calls) // cfg.spp
    check("phase10 (c) each sample makes the same number of trace calls",
          per * cfg.spp == len(rec.calls), f"({len(rec.calls)} calls)")
    st = main_call_stats(torch, np, traverse, isect, rec.calls,
                         "phase10 (c) per-sample frame",
                         checked=set(range(len(rec.calls) - per, len(rec.calls))))
    del rec
    for kind, name in (("nearest", "nearest_kernel"), ("anyhit", "anyhit_kernel")):
        k = st[kind]
        fb, fby = bound_of(k["ops_ms"], k["bytes_ms"])
        sb, sby = bound_of(k["s_ops_ms"], k["s_bytes_ms"])
        print(f"phase10 (c) per-sample frame {name}: {k['ms']:.3f} ms in "
              f"{k['calls']} launches, {int(k['counts'][2])} tri tests, bound "
              f"{fb:.4f} ms ({fby}); samples ({k['s_rays']} rays over "
              f"{k['s_calls']} calls) {k['s_ms']:.3f} ms vs plain "
              f"{k['s_plain_ms']:.3f} ms, bound {sb:.4f} ms ({sby}), max abs "
              f"err {k['s_err']:.3g}; card {smi}", flush=True)
        check(f"phase10 (c) per-sample {name} held against its plain version",
              k["s_calls"] > 0, f"({k['s_calls']} calls)")
        out[name] = {"ms": k["s_ms"], "plain_ms": k["s_plain_ms"],
                     "max_abs_err": k["s_err"], "bound_ms": sb, "bound_by": sby,
                     "frame_ms": k["ms"], "frame_bound_ms": fb,
                     "frame_bound_by": fby, "frame_launches": k["calls"],
                     "frame_tri_tests": int(k["counts"][2]),
                     "sample": f"{SAMPLE_PACKETS} live packets of each call of "
                               f"the last sample of one per-sample frame "
                               f"({k['s_rays']} rays), full pages"}
    return out


def rng_bound_parts(n, k, tensor_sample):
    """(ms for the operations at the dispatch rate, ms for the bytes at the
    memory rate) of one threefry_uniform_kernel launch; its bound is the
    larger.  RNG_DIM_OPS integer operations a dim, each a dispatched
    instruction (the int32 lanes' 64 a clock an SM is no ceiling: integer
    adds go to the FMA pipe too); the counters read once (16 bytes a ray,
    8 with one sample id for all) and k float32 uniforms written once."""
    nbytes = n * ((16 if tensor_sample else 8) + 4 * k)
    return n * k * RNG_DIM_OPS / DISPATCH_S * 1e3, nbytes / HBM_BYTES_S * 1e3


def device_ms(torch, fn, reps):
    """(ms a call on the device, ms a call on the host, ms the device slept):
    reps calls of fn() enqueued behind a sleep kernel, after one warm-up,
    so that CUDA events time the device's back-to-back work and not the
    host's enqueue rate (which holds only while the host's enqueue takes
    less than the sleep)."""
    fn()
    torch.cuda.synchronize()
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host / reps, s.elapsed_time(a)


def rng_frame(torch, fn, arrays, record=None):
    """One frame of `fn`, every kernel's launch count set to 0 just before
    it and read just after, with the allocator's peak above what was
    allocated before it (requested bytes, and the blocks that hold them);
    `record`, a list, gets each `rng.uniforms` call's arguments."""
    from spray_tpu_torch.core import rng

    plain = rng.uniforms

    def recorded(seed, pixel, sample, dims):
        record.append((seed, pixel, sample, tuple(dims)))
        return plain(seed, pixel, sample, dims)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if record is not None:
        rng.uniforms = recorded
    try:
        img = fn(arrays)
        torch.cuda.synchronize()
    finally:
        rng.uniforms = plain
    launches = read_launches()
    st = torch.cuda.memory_stats()
    peak = {"allocated": st["allocated_bytes.all.peak"] - base,
            "requested": st.get("requested_bytes.all.peak", base) - base}
    return img, launches, peak


def phase11_rng(torch, np, scene, pages, cam, dev, smi):
    """threefry_uniform_kernel on the main path: the bench frame through
    the default multi-domain intersector at the offline cell's spp 16,
    bounces 3 and at phase 4's spp 4, bounces 2, batched.  Each frame
    launches the kernel 1 + 2 x bounces times (the jitter pair, then the
    light triple and the BSDF pair at every bounce but the last), and its
    image is byte-equal to the same frame with `rng.uniforms` drawing by the
    plain int64 version on the card's tensors; the allocator's peak of each
    (requested bytes and the blocks that hold them).  At spp 16 every
    recorded draw site (the frame's own pixel and sample tensors) is drawn
    again by the kernel, bit-equal to the plain version dim by dim, and
    timed (RNG_REPS launches behind a sleep kernel, CUDA events) against
    its bound and against the plain version; so is one draw with one
    sample id for all rays."""
    from spray_tpu_torch.core import rng
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.integrators.device import make_render_fn
    from spray_tpu_torch.integrators.wavefront import make_scene_arrays
    from spray_tpu_torch.kernels.multidomain import MultiDomainClusterIntersector

    def plain_uniforms(seed, pixel, sample, dims):
        return tuple(rng._uniform_plain(seed, pixel, sample, d) for d in dims)

    isect = MultiDomainClusterIntersector.from_pages(scene, pages, device=dev)
    arrays = make_scene_arrays(scene, dev)
    out = {"card": smi}
    for spp, bounces, seed in ((16, 3, 2862024101), (4, 2, 0)):
        tag = f"phase11 spp {spp} bounces {bounces}"
        cfg = RenderConfig(width=cam.width, height=cam.height, spp=spp,
                           bounces=bounces, integrator="pt", nee=True, seed=seed)
        fn = make_render_fn(scene, cam, cfg, isect, device=dev)
        check(f"{tag}: the batched form", fn.spp_batch is True)
        fn(arrays)  # warm-up
        calls = []
        img, launches, peak = rng_frame(torch, fn, arrays, calls)
        n_k = launches["threefry_uniform_kernel"]
        check(f"{tag}: threefry_uniform_kernel launched 1 + 2 x bounces times "
              "a frame, once a draw site", n_k == 1 + 2 * bounces == len(calls),
              f"({n_k} launches, {len(calls)} draw sites)")
        saved, rng.uniforms = rng.uniforms, plain_uniforms
        try:
            ref, plain_launches, plain_peak = rng_frame(torch, fn, arrays)
        finally:
            rng.uniforms = saved
        check(f"{tag}: no kernel launch with the plain version",
              plain_launches["threefry_uniform_kernel"] == 0)
        check(f"{tag}: image byte-equal to the plain version's",
              img.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes(),
              f"(max abs {float((img - ref).abs().max()):.3g})")
        print(f"{tag}: {n_k} kernel launches a frame; peak above the frame's "
              f"start, kernel {peak} B, plain {plain_peak} B (requested bytes, "
              f"allocated blocks); card {smi}", flush=True)
        row = {"launches": n_k, "frame_peak_bytes": peak,
               "plain_frame_peak_bytes": plain_peak}
        del img, ref, fn
        if spp == 16:
            row.update(rng_draw_sites(torch, rng, calls, tag, smi))
        del calls
        out[f"spp{spp}"] = row
    return out


def rng_draw_sites(torch, rng, calls, tag, smi):
    """Every recorded draw site of one frame drawn again by the kernel,
    bit-equal to the plain version dim by dim on the same card tensors, and
    timed against its bound and the plain version; then the first site's
    pixels with one sample id for all.  Returns the kernels JSON's numbers."""
    sites = list(calls)
    seed0, pix0, _, dims0 = sites[0]
    sites.append((seed0, pix0, 7, dims0))  # the per-sample form's draw
    fr = dict.fromkeys(("ms", "host_ms", "plain_ms", "ops_ms", "bytes_ms"), 0.0)
    err, rows = 0.0, []
    for i, (seed, pix, smp, dims) in enumerate(sites):
        n, k, tensor = pix.shape[0], len(dims), isinstance(smp, torch.Tensor)
        got = rng.uniforms(seed, pix, smp, dims)
        want = [rng._uniform_plain(seed, pix, smp, d) for d in dims]
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        err = max(err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
        del got, want
        check(f"{tag} draw site {i} (n {n}, k {k}, "
              f"{'tensor' if tensor else 'one'} sample) bit-equal to the plain "
              "version", same)
        ms, host_ms, slept = device_ms(
            torch, lambda: rng.uniforms(seed, pix, smp, dims), RNG_REPS)
        check(f"{tag} draw site {i}: the device timed behind its queue",
              host_ms * RNG_REPS < slept,
              f"(enqueue {host_ms * RNG_REPS:.2f} ms, sleep {slept:.2f} ms)")
        plain_ms = cuda_ms(torch, lambda: [rng._uniform_plain(seed, pix, smp, d)
                                           for d in dims], 2)
        t_ops, t_bytes = rng_bound_parts(n, k, tensor)
        bms, by = bound_of(t_ops, t_bytes)
        rows.append({"n": n, "k": k, "tensor_sample": tensor, "ms": ms,
                     "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by})
        print(f"{tag} draw site {i}: n {n}, k {k}, "
              f"{'tensor' if tensor else 'one'} sample: {ms:.4f} ms a launch "
              f"on the device ({bms / ms:.1%} of bound {bms:.4f} ms, {by}), "
              f"{host_ms:.4f} ms a call on the host, vs plain {plain_ms:.3f} "
              f"ms; card {smi}", flush=True)
        if i < len(calls):
            fr["ms"] += ms
            fr["host_ms"] += host_ms
            fr["plain_ms"] += plain_ms
            fr["ops_ms"] += t_ops
            fr["bytes_ms"] += t_bytes
    fb, fby = bound_of(fr["ops_ms"], fr["bytes_ms"])
    k3 = next(r for r in rows if r["k"] == 3 and r["tensor_sample"])
    print(f"{tag}: threefry_uniform_kernel a frame {fr['ms']:.4f} ms in "
          f"{len(calls)} launches ({fb / fr['ms']:.1%} of bound {fb:.4f} ms, "
          f"{fby}; {fr['host_ms']:.4f} ms on the host) vs plain "
          f"{fr['plain_ms']:.3f} ms; card {smi}", flush=True)
    return {"frame_ms": fr["ms"], "frame_host_ms": fr["host_ms"],
            "frame_plain_ms": fr["plain_ms"],
            "frame_bound_ms": fb, "frame_bound_by": fby,
            "frame_launches": len(calls), "max_abs_err": err, "sites": rows,
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
            "bound_by": k3["bound_by"], "n": k3["n"]}


def main_call_stats(torch, np, traverse, isect, calls, tag, checked=None):
    """The nearest and any-hit calls of one frame through the multi-domain
    intersector `isect`, recorded by Recorder: every call's kernel timed
    against its bound (node visits and tri tests counted on the call); the
    calls whose index is in `checked` (default: every call) held on
    SAMPLE_PACKETS live packets against the plain version, and on their
    middle packet against walk_reference bit for bit with the counts, with
    the one-entry-list designs checked too when every call is.  Returns
    sums by kind: ms, bound parts and counts over every call; s_* over the
    checked calls' samples."""
    dev = isect.w.device
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    pages = tuple(x.cpu() for x in (isect.bounds, isect.meta, isect.w))
    keys = ("ms", "bound_ms", "ops_ms", "bytes_ms", "s_ms", "s_plain_ms",
            "s_ops_ms", "s_bytes_ms", "s_err")
    stats = {k: {**dict.fromkeys(keys, 0.0), "calls": 0, "s_calls": 0,
                 "s_rays": 0, "counts": np.zeros(3)} for k in ("nearest", "anyhit")}
    for i, (kind, wo, wd, wmin, wmax) in enumerate(calls):
        args, _ = isect._args(wo, wd, wmin, wmax)
        counters.zero_()
        run_kernel(traverse, kind, args, counters)
        cnt = counters.cpu().numpy().astype(np.float64)
        ms = cuda_ms(torch, lambda: run_kernel(traverse, kind, args))
        parts = bound_parts(torch, kind, args, cnt)
        bms, by = bound_of(*parts)
        live = int((wmax > 0).sum())
        s = stats[kind]
        for key, val in (("ms", ms), ("ops_ms", parts[0]), ("bytes_ms", parts[1]),
                         ("bound_ms", bms)):
            s[key] += val
        s["calls"] += 1
        s["counts"] += cnt
        line = (f"{tag} call {i} {kind}: {live} live rays, {int(cnt[0])} node "
                f"visits, {int(cnt[1])} leaf visits, {int(cnt[2])} tri tests; "
                f"{ms:.3f} ms vs bound {bms:.4f} ms ({by})")
        if checked is not None and i not in checked:
            print(line, flush=True)
            continue
        # the kernel against its plain version on a sample of this call
        sub = sample_packets(torch, args, SAMPLE_PACKETS)
        counters.zero_()
        run_kernel(traverse, kind, sub, counters)
        s_cnt = counters.cpu().numpy().astype(np.float64)
        got = run_kernel(traverse, kind, sub)
        ref, s_plain_ms = timed_once(torch, lambda: run_plain(traverse, kind, sub))
        n_pk = sub[0].shape[0]
        err = compare_raw(f"{tag} call {i} {kind} kernel~plain on {n_pk} "
                          "main-path packets", kind, ref, got)
        check_walk(torch, traverse, f"{tag} call {i} full lists", kind,
                   pick_packets(torch, sub, middle(torch, n_pk, dev)), pages)
        if checked is None:
            check_designs(torch, traverse, f"{tag} call {i}", kind, sub, pages)
        s_ms = cuda_ms(torch, lambda: run_kernel(traverse, kind, sub))
        s_parts = bound_parts(torch, kind, sub, s_cnt)
        print(f"{line}; sample of {n_pk} packets {s_ms:.3f} ms vs plain "
              f"{s_plain_ms:.3f} ms", flush=True)
        for key, val in (("s_ms", s_ms), ("s_plain_ms", s_plain_ms),
                         ("s_ops_ms", s_parts[0]), ("s_bytes_ms", s_parts[1])):
            s[key] += val
        s["s_err"] = max(s["s_err"], err)
        s["s_rays"] += sub[1].shape[0]
        s["s_calls"] += 1
    return stats


def frame_numbers(s, frame_sample):
    """The per-frame numbers of a stats dict of `slot_kernel_stats`."""
    return {"ms": s["s_ms"], "plain_ms": s["s_plain_ms"], "max_abs_err": s["s_err"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "frame_ms": s["ms"], "frame_bound_ms": s["frame_bound_ms"],
            "frame_bound_by": s["frame_bound_by"], "frame_launches": s["calls"],
            "frame_tri_tests": int(s["counts"][2]),
            "sample": f"{SLOT_SAMPLE_PACKETS} live packets and one dead packet "
                      f"of {s['s_calls']} calls of one {frame_sample} frame "
                      f"({s['s_rays']} rays)"}


def kernel_entry(name, source, replaces, launches, s, by_path, sample, extra=None):
    """One entry of the kernels JSON from a stats dict with the sample keys
    (s_ms, s_plain_ms, s_err, bound_ms, bound_by) and the frame keys."""
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": s["s_err"], "ms": s["s_ms"],
        "plain_ms": s["s_plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None, "frame_ms": s["ms"],
        "frame_bound_ms": s["frame_bound_ms"],
        "frame_bound_by": s["frame_bound_by"], "frame_launches": s["launches"],
        "sample": sample, "launches_by_path": by_path,
    }
    entry.update(extra or {})
    return entry


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (ROOT / "spray_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: spray_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from spray_tpu_torch.core.camera import make_camera
    from spray_tpu_torch.core.config import RenderConfig
    from spray_tpu_torch.integrators.device import make_render_fn
    from spray_tpu_torch.integrators.wavefront import make_scene_arrays
    from spray_tpu_torch.io.scenes import cornell_box, wisp_cloud
    from spray_tpu_torch import native
    from spray_tpu_torch.kernels import _build, traverse
    from spray_tpu_torch.kernels.multidomain import (
        MultiDomainClusterIntersector, build_cluster_domains,
    )
    from spray_tpu_torch.oracle.brute import BruteIntersector
    from spray_tpu_torch.render import make_pipeline, render

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    def build_one(src):
        t0 = time.perf_counter()
        _, log = _build.build(src.stem)
        return src, log, time.perf_counter() - t0

    def build_native():
        t0 = time.perf_counter()
        return native.load(), time.perf_counter() - t0

    sources = sorted(_build.CSRC.glob("*.cu"))
    built = {}
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(build_native)
        for src, log, secs in pool.map(build_one, sources):
            report = _build.ptxas_report(log)
            built.update(report)
            print(f"build {src.name} into {_build.BUILD_DIR.relative_to(ROOT)}: "
                  f"{secs:.2f} s; " + " | ".join(
                      f"{k}: {v['registers']} registers, {v['smem']} bytes of "
                      f"shared memory, {v['stack']} bytes of stack, spill stores "
                      f"{v['spill_stores']} loads {v['spill_loads']} bytes"
                      for k, v in report.items()), flush=True)
        lib, secs = host.result()
    print(f"build {native.SRC.name} with g++ into "
          f"{Path(lib._name).parent.relative_to(ROOT)}: {secs:.2f} s", flush=True)
    blocks_per_sm = {
        k: _build.load("traverse").spray_blocks_per_sm(i)
        for i, k in enumerate(("nearest_kernel", "anyhit_kernel",
                               "nearest_slot_kernel"))}
    binned_lib = _build.load("binned")
    binned_span, binned_bps = (binned_lib.spray_binned_span(),
                               binned_lib.spray_binned_blocks_per_sm())
    anyhit_span = binned_lib.spray_binned_anyhit_span()
    print("occupancy (resident blocks of 256 threads per SM, of the 8 that "
          f"fill its 64 warps): {blocks_per_sm}; binned_nearest_kernel: "
          f"{binned_bps} blocks of 128 threads per SM, {binned_span} visits a "
          f"block; binned_anyhit_kernel: {anyhit_span} visits a block", flush=True)
    check("phase1 binned_nearest_kernel resident on the card", binned_bps > 0,
          f"({binned_bps} blocks per SM)")
    for k in WARP_PER_RAY:
        v = built.get(k, {})
        check(f"phase1 {k}: no register spill, shared memory under 48 KB, "
              "resident on the card",
              v.get("spill_stores") == 0 and v.get("spill_loads") == 0
              and 0 < v.get("smem", 0) < 48 * 1024 and blocks_per_sm[k] > 0,
              f"({v}, {blocks_per_sm[k]} blocks per SM)")
    reset_launches()
    phase_done("phase1 (build)")

    # ---- phase 2: kernel parity on a small scene ----------------------------
    small = wisp_cloud(n_blobs=8, tris_per_blob=2048, seed=3)
    sisect = MultiDomainClusterIntersector(small, n_domains=6, device=dev)
    brute = BruteIntersector(small, device=dev)
    print(f"phase2: scene {small.num_faces} tris, {sisect.n_domains} domains, "
          f"tree depth {sisect.depth}", flush=True)
    n = 16384
    o, d = rand_rays(torch, small, n, 0, dev)
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), float("inf"), device=dev)
    far = torch.full((n,), 1e30, device=dev)
    rec = Recorder(sisect)
    cam64 = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                        fov_y_deg=45, width=64, height=64)
    cfg64 = RenderConfig(spp=1, bounces=2, integrator="pt", seed=0)
    render(small, cam64, cfg64, intersector=rec, device=dev)
    bounce1 = [c for c in rec.calls if c[0] == "nearest"][1]
    shadow = [c for c in rec.calls if c[0] == "anyhit"][0]
    waves = [("random", "nearest", (o, d, tmin, tmax)),
             ("random", "anyhit", (o, d, tmin, far)),
             ("bounce1", "nearest", bounce1[1:]),
             ("shadow0", "anyhit", shadow[1:])]
    small_pages = tuple(x.cpu() for x in (sisect.bounds, sisect.meta, sisect.w))
    for tag, kind, (wo, wd, wmin, wmax) in waves:
        args, _ = sisect._args(wo, wd, wmin, wmax)
        got = run_kernel(traverse, kind, args)
        torch.cuda.synchronize()  # a fault of the kernel shows here
        ref = run_plain(traverse, kind, args)
        torch.cuda.synchronize()
        compare_raw(f"phase2 {tag} {kind} kernel~plain", kind, ref, got)
        if kind == "nearest":
            compare_hits(f"phase2 {tag} nearest kernel~brute",
                         brute.intersect(wo, wd, wmin, wmax),
                         sisect.intersect(wo, wd, wmin, wmax))
        else:
            ob = brute.occluded(wo, wd, wmax)
            ok = sisect.occluded(wo, wd, wmax)
            check(f"phase2 {tag} anyhit kernel~brute occlusion equal",
                  bool((ob == ok).all()), f"({int((ob != ok).sum())} differ)")
        torch.cuda.synchronize()
        # the kernels against the host's walk and the two nearest entry
        # points against each other, a synchronise after each launch
        n_pk = args[0].shape[0]
        check_walk(torch, traverse, f"phase2 {tag} full lists", kind,
                   pick_packets(torch, args, middle(torch, n_pk, dev)), small_pages)
        check_designs(torch, traverse, f"phase2 {tag}", kind, args, small_pages)
    tdead = tmax.clone()
    tdead[1024:4096] = 0.0  # packets 4-15 dead
    phase2_slot(torch, traverse, small, brute,
                [("random", (o, d, tmin, tdead)), ("bounce1", bounce1[1:])], dev)
    phase2_alternates(torch, np, small, brute,
                      waves + [("random_dead", "nearest", (o, d, tmin, tdead)),
                               ("random_dead", "anyhit", (o, d, tmin,
                                                          tdead.clamp(max=1e30)))],
                      dev)
    check_split_tie(torch, np, small, dev)
    phase2_bvh(torch, small, waves, dev, smi)

    phase_done("phase2 (kernel parity)")

    # ---- phase 3: path parity -------------------------------------------------
    img_k = render(small, cam64, cfg64, intersector=sisect, device=dev)
    img_p = render(small, cam64, cfg64, intersector=PlainIntersector(sisect),
                   device=dev)
    torch.cuda.synchronize()
    err = float(np.abs(img_k - img_p).max())
    check("phase3 64x64 PT+NEE kernels~plain allclose(atol 2e-3, rtol 1e-3)",
          bool(np.allclose(img_k, img_p, atol=2e-3, rtol=1e-3)),
          f"(max abs {err:.3g}, mean {img_k.mean():.5f})")
    phase3_grads(torch, make_pipeline, small, cam64, cfg64, sisect, dev)
    phase3_alternates(torch, np, small, cam64, cfg64, sisect, img_k, dev)

    phase_done("phase3 (path parity)")

    # ---- phase 4: the main path at full size --------------------------------
    t0 = time.perf_counter()
    scene = wisp_cloud(n_blobs=8, tris_per_blob=131072, seed=3)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    pages = build_cluster_domains(scene)
    t_pages = time.perf_counter() - t0
    isect = MultiDomainClusterIntersector.from_pages(scene, pages, device=dev)
    print(f"phase4: scene {scene.num_faces} tris in {t_scene:.2f} s; "
          f"{isect.n_domains} domains, pages w {tuple(isect.w.shape)}, "
          f"tree depth {isect.depth}, built in {t_pages:.2f} s", flush=True)
    cam = make_camera(eye=(14.0, 10.0, 18.0), lookat=(0, 0, 0), up=(0, 1, 0),
                      fov_y_deg=45, width=512, height=512)
    cfg = RenderConfig(width=512, height=512, spp=4, bounces=2,
                       integrator="pt", nee=True, seed=0)
    pipe = make_pipeline(scene, cam, cfg, backward=False, intersector=isect,
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, _ = pipe.run()  # warm-up frame
    print(f"phase4: warm-up frame {time.perf_counter() - t0:.3f} s", flush=True)
    reset_launches()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.run()  # synchronises the card before returning
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    img = out[0]
    rays = pipe.rays_traced(out)
    frame = min(times)
    profile_top(torch, "phase4 forward frame", pipe.run)
    peak = torch.cuda.max_memory_allocated()
    mean = float(img.mean())
    print(f"phase4: frame times {[round(t, 4) for t in times]} s; min {frame:.4f} s;"
          f" rays_traced {rays}; {rays / frame / 1e9:.6f} Grays/s; "
          f"peak memory {peak / 2**30:.3f} GiB; card {smi}", flush=True)
    print(f"phase4: image {tuple(img.shape)} mean {mean:.6f}; launches over 3 "
          f"frames {launches}", flush=True)
    check("phase4 image finite and nonzero",
          bool(torch.isfinite(img).all()) and mean > 0, f"(mean {mean:.6f})")
    check("phase4 rays traced > 0", rays > 0, f"({rays})")
    for k in ("nearest_kernel", "anyhit_kernel"):
        check(f"phase4 {k} launched on the forward path", launches[k] > 0,
              f"({launches[k]})")

    # per-kernel time, tests and bound at the main path's shapes
    rec = Recorder(isect)
    fn = make_render_fn(scene, cam, cfg, rec, with_stats=True, device=dev)
    fn(make_scene_arrays(scene, dev))
    torch.cuda.synchronize()
    stats = main_call_stats(torch, np, traverse, isect, rec.calls, "phase4")
    shadows = [c for c in rec.calls if c[0] == "anyhit"]
    del rec

    phase_done("phase4 (forward frame)")

    # ---- phases 5 and 6: the scheduler and the training step ---------------
    sched, sched_launches = phase5_scheduler(torch, np, scene, cam, isect, dev,
                                             smi)
    slot, sched_any = sched["nearest"], sched["anyhit"]
    phase_done("phase5 (scheduler)")
    train, train_launches, train_ref = phase6_train(torch, scene, cam, cfg,
                                                    isect, dev, smi)
    phase_done("phase6 (training step)")

    # ---- phase 7: the alternate intersectors at full width ------------------
    visit, visit_frames, visit_launches = {}, {}, {}
    for prefer in ("sweep", "binned"):
        visit_frames[prefer], visit[prefer], visit_launches[prefer] = (
            phase7_visit_path(torch, np, prefer, scene, cam, cfg, img, dev, smi))
        phase_done(f"phase7 ({prefer})")
    check_split_anyhit(torch, np, dev)
    check_brute_anyhit(torch, np, dev)
    routed, grid_k, routed_launches = phase7_routed(
        torch, np, scene, pages, cam, cfg, isect, img, shadows, dev, smi)
    del shadows
    phase_done("phase7 (routed)")
    brute_k, brute_frames, brute_launches = {}, {}, {}
    for tag, bscene in (("cornell", cornell_box()), ("wisp41k", small)):
        bcam = make_camera(eye=(0.5, 0.5, 2.2), lookat=(0.5, 0.5, 0.0),
                           up=(0, 1, 0), fov_y_deg=40, width=512,
                           height=512) if tag == "cornell" else cam
        brute_frames[tag], brute_k[tag], brute_launches[tag] = phase7_brute(
            torch, np, tag, bscene, bcam, cfg, dev, smi)
    phase_done("phase7 (brute)")

    # ---- phase 8: the distributed paths, a world of one NCCL rank -----------
    from spray_tpu_torch.dist.launch import run_world

    del isect, pipe, out, img
    torch.cuda.empty_cache()
    p8 = run_world(phase8_rank, 1, smi, train_ref)[0]
    FAILED.extend(p8["failed"])
    phase_done("phase8 (distributed)")

    # ---- phase 9: native builder, CLI, fit, viewer, bench entry, gate -------
    import tempfile

    p9_t0 = time.perf_counter()
    p9 = {"native": phase9_native(np, scene, pages, rays)}
    with tempfile.TemporaryDirectory() as tmp:
        p9["cli"] = phase9_cli(tmp, smi)
        p9["fit"] = phase9_fit(torch, np, small, tmp, dev)
    p9["viewer"] = phase9_viewer(torch, np, small, dev)
    p9["bench"], p9["gate"], p9["insitu_gate"] = phase9_bench_and_gate(
        train["rays_traced"], smi)
    p9["phase9_s"] = time.perf_counter() - p9_t0
    print(f"phase9 took {p9['phase9_s']:.1f} s", flush=True)
    phase_done("phase9 (native, cli, fit, viewer, bench, gate)")

    # ---- phase 10: the form of the frame, chosen by free memory -----------
    p10 = phase10_spp(torch, np, scene, pages, cam, cfg, dev, smi)
    phase_done("phase10 (batched and per-sample frames)")

    # ---- phase 11: the Threefry kernel on the main path ---------------------
    p11 = phase11_rng(torch, np, scene, pages, cam, dev, smi)
    del pages
    phase_done("phase11 (threefry kernel)")
    by_path = {k: {"forward": launches[k], "scheduler": sched_launches[k],
                   "train": train_launches[k],
                   "routed_grid": routed_launches[k],
                   "rayshard": p8["launches"]["rayshard"][k],
                   "insitu": p8["launches"]["insitu"][k],
                   **{f"cli_{t}": p9["cli"][t]["launches"][k]
                      for t in ("one_shot", "ooc", "baseline")},
                   "fit": p9["fit"]["launches"][k],
                   "viewer": p9["viewer"]["launches"][k],
                   **{f"phase10_{t}": p10[t]["launches"][k]
                      for t in ("batched", "per_sample")}}
               for k in launches}

    kernels = []
    for kind, name, replaces in (
        ("nearest", "nearest_kernel", "spray_tpu/kernels/traverse.py:379"),
        ("anyhit", "anyhit_kernel", "spray_tpu/kernels/traverse.py:658"),
    ):
        s = stats[kind]
        fby = "operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes"
        bms, by = bound_of(s["s_ops_ms"], s["s_bytes_ms"])
        print(f"phase4 {name} (warp per ray): per frame {s['ms']:.3f} ms in "
              f"{s['calls']} launches ({launches[name] / 3:.0f} per timed frame), "
              f"{int(s['counts'][2])} tri tests, bound {s['bound_ms']:.4f} ms "
              f"({fby}); samples ({s['s_rays']} rays over {s['calls']} calls) "
              f"{s['s_ms']:.3f} ms vs plain {s['s_plain_ms']:.3f} ms, bound "
              f"{bms:.4f} ms ({by}); card {smi}", flush=True)
        entry = {
            "name": name, "route": "cuda",
            "source": "spray_tpu_torch/kernels/csrc/traverse.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["s_err"], "ms": s["s_ms"],
            "plain_ms": s["s_plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "frame_ms": s["ms"], "frame_bound_ms": s["bound_ms"],
            "frame_bound_by": fby, "frame_launches": s["calls"],
            "frame_tri_tests": int(s["counts"][2]),
            "sample": f"{SAMPLE_PACKETS} live packets of each main-path call "
                      f"({s['s_rays']} rays), full pages",
            "launches_by_path": by_path[name],
            "design": "warp_per_ray", "blocks_per_sm": blocks_per_sm[name],
        }
        if kind == "anyhit":
            # The full (P, R) lists of the forward path stand for the TPU's
            # fused any-hit (`_anyhit_fused_kernel`, traverse.py:535); the
            # one-entry lists of the scheduler and of the per-round routed
            # modes for its per-round `_anyhit_kernel` (traverse.py:658),
            # held against the plain version there too.
            entry["replaces"] = ("spray_tpu/kernels/traverse.py:535 (full "
                                 "domain lists), spray_tpu/kernels/"
                                 "traverse.py:658 (one-entry lists)")
            entry["anyhit_forms_ms"] = routed["anyhit_forms"]
            entry["max_abs_err"] = max(s["s_err"], sched_any["s_err"],
                                       grid_k["anyhit"]["s_err"])
            entry["scheduler"] = {"launches": sched_launches[name],
                                  **frame_numbers(sched_any, "config4_noprefetch")}
            entry["routed_grid"] = {"launches": routed_launches[name],
                                    **frame_numbers(grid_k["anyhit"], "routed='grid'")}
            entry["insitu"] = {"launches": p8["launches"]["insitu"][name],
                               **frame_numbers(p8["stats"]["anyhit"],
                                               "in-situ 512x512")}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       p8["stats"]["anyhit"]["s_err"])
        entry["per_sample"] = {
            "launches": p10["per_sample"]["launches"][name], **p10[name]}
        entry["max_abs_err"] = max(entry["max_abs_err"], p10[name]["max_abs_err"])
        kernels.append(entry)
    kernels.append({
        "name": "nearest_slot_kernel", "route": "cuda",
        "source": "spray_tpu_torch/kernels/csrc/traverse.cu",
        "replaces": "spray_tpu/kernels/traverse.py:281",
        "launches": sched_launches["nearest_slot_kernel"], "library_ms": None,
        **frame_numbers(slot, "config4_noprefetch"),
        "max_abs_err": max(slot["s_err"], grid_k["nearest"]["s_err"],
                           p8["stats"]["nearest"]["s_err"]),
        "launches_by_path": by_path["nearest_slot_kernel"],
        "design": "warp_per_ray", "blocks_per_sm": blocks_per_sm["nearest_slot_kernel"],
        "routed_grid": {"launches": routed_launches["nearest_slot_kernel"],
                        **frame_numbers(grid_k["nearest"], "routed='grid'")},
        "insitu": {"launches": p8["launches"]["insitu"]["nearest_slot_kernel"],
                   **frame_numbers(p8["stats"]["nearest"], "in-situ 512x512")},
    })
    binned_src = "spray_tpu_torch/kernels/csrc/binned.cu"
    brute_src = "spray_tpu_torch/kernels/csrc/brute.cu"
    for kind, line in (("nearest", 303), ("anyhit", 343)):
        name = f"binned_{kind}_kernel"
        sw, bn = visit["sweep"][kind], visit["binned"][kind]
        kernels.append(kernel_entry(
            name, binned_src, f"spray_tpu/kernels/binned.py:{line}",
            sum(v[name] for v in visit_launches.values()), sw,
            {p: v[name] for p, v in visit_launches.items()},
            f"{VISIT_SAMPLE_RUNS} runs (their first {VISIT_SAMPLE_LEN} visits) "
            f"of {VISIT_SAMPLE_LAUNCHES} launches of each trace call of one "
            f"sweep frame ({sw['s_runs']} runs)",
            {"max_abs_err": max(sw["s_err"], bn["s_err"]),
             "frame_visits": sw["visits"], "frame_clusters": sw["clusters"],
             "frame_runs": sw["runs"], "frame_longest_run": sw["longest_run"],
             "frame_blocks": sw["blocks"],
             **({"design": f"split_runs, {binned_span} visits a block",
                 "blocks_per_sm": binned_bps} if kind == "nearest" else
                {"design": f"split_runs, {anyhit_span} visits a block, flags "
                           "shared in place",
                 "bound_counts": "tests the serial order needs",
                 "frame_serial_tests": sw["serial_tests"],
                 "frame_kernel_tests": sw["kernel_tests"],
                 "frame_extra_work": sw["extra_work"]}),
             "binned": {"max_abs_err": bn["s_err"], "ms": bn["s_ms"],
                        "plain_ms": bn["s_plain_ms"], "bound_ms": bn["bound_ms"],
                        "bound_by": bn["bound_by"], "frame_ms": bn["ms"],
                        "frame_bound_ms": bn["frame_bound_ms"],
                        "frame_bound_by": bn["frame_bound_by"],
                        "frame_launches": bn["launches"],
                        "frame_visits": bn["visits"],
                        "frame_clusters": bn["clusters"], "frame_runs": bn["runs"],
                        "frame_longest_run": bn["longest_run"],
                        "frame_blocks": bn["blocks"],
                        **({"frame_serial_tests": bn["serial_tests"],
                            "frame_kernel_tests": bn["kernel_tests"],
                            "frame_extra_work": bn["extra_work"]}
                           if kind == "anyhit" else {})}}))
    for kind, line in (("nearest", 57), ("anyhit", 84)):
        name = f"brute_{kind}_kernel"
        w, c = brute_k["wisp41k"][kind], brute_k["cornell"][kind]
        kernels.append(kernel_entry(
            name, brute_src, f"spray_tpu/kernels/brute.py:{line}",
            sum(v[name] for v in brute_launches.values()), w,
            {p: v[name] for p, v in brute_launches.items()},
            f"{BRUTE_SAMPLE_BLOCKS} blocks of 256 rays of each call of one "
            f"frame on {brute_frames['wisp41k']['tris']} tris ({w['s_rays']} rays)",
            {"max_abs_err": max(w["s_err"], c["s_err"]),
             "design": "live-ray queue, a ray a thread, staged test, 16-byte "
                       "table rows" + ("" if kind == "nearest" else
                                       ", stops at the first hit"),
             **({} if kind == "nearest" else {
                 "bound_counts": "tests the serial order needs",
                 "frame_serial_tests": w["serial_tests"],
                 "frame_kernel_tests": w["kernel_tests"]}),
             "cornell": {"max_abs_err": c["s_err"], "ms": c["s_ms"],
                         "plain_ms": c["s_plain_ms"], "bound_ms": c["bound_ms"],
                         "bound_by": c["bound_by"], "frame_ms": c["ms"],
                         "frame_bound_ms": c["frame_bound_ms"],
                         "frame_bound_by": c["frame_bound_by"],
                         "frame_launches": c["launches"]}}))
    r16 = p11["spp16"]
    kernels.append({
        "name": "threefry_uniform_kernel", "route": "cuda",
        "source": "spray_tpu_torch/kernels/csrc/rng.cu",
        "replaces": "none (the reference's jnp threefry2x32, "
                    "spray_tpu/core/rng.py:52)",
        "launches": launches["threefry_uniform_kernel"],
        "max_abs_err": r16["max_abs_err"], "ms": r16["ms"],
        "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
        "bound_by": r16["bound_by"], "library_ms": None,
        "frame_ms": r16["frame_ms"], "frame_plain_ms": r16["frame_plain_ms"],
        "frame_bound_ms": r16["frame_bound_ms"],
        "frame_bound_by": r16["frame_bound_by"],
        "frame_launches": r16["frame_launches"],
        "sample": f"the light triple's draw site of one spp-16 frame "
                  f"({r16['n']} rays, K = 3, a sample id a ray)",
        "frame": "512x512, spp 16, bounces 3: every draw site of one frame, "
                 "each on its own pixel and sample tensors",
        "sites": r16["sites"], "launches_by_path": by_path["threefry_uniform_kernel"],
        "design": "a thread a ray, grid-stride, K dims in registers on "
                  "native uint32, rows written coalesced",
    })
    for k in kernels:
        check(f"kernels line: {k['name']} launched on its path", k["launches"] > 0,
              f"({k['launches']})")
    print(json.dumps({"scheduler": slot["configs"], "train": train,
                      "alternates": {"sweep": visit_frames["sweep"],
                                     "binned": visit_frames["binned"],
                                     "routed_grid": routed,
                                     "brute": brute_frames},
                      "dist": {k: p8[k] for k in ("rayshard", "insitu", "gate")},
                      "phase9": p9, "phase10": p10, "phase11": p11}),
          flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} check(s) failed: {FAILED}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
