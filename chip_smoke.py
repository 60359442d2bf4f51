#!/usr/bin/env python3
"""Smoke run of spray_tpu_torch on one CUDA card: build, parity, main path.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check makes the run exit 1):
  1. the card's name and power limit; nvcc builds every kernel source of
     spray_tpu_torch/kernels/csrc into build/kernels/;
  2. kernel parity: each CUDA kernel against its plain PyTorch version and
     the torch brute oracle, on a 41K-tri wisp scene (6 domains), 16,384
     random rays plus the bounce-1 and shadow wavefronts of a small render;
  3. path parity: a 64x64 PT+NEE frame through the kernels == the same frame
     through the plain versions (the PlainIntersector proxy), on the card;
  4. the main path at full size: make_pipeline(backward=False) on
     wisp_cloud(n_blobs=8, tris_per_blob=131072, seed=3) (2,621,442 tris,
     21 domains), 512x512, spp 4, bounces 2, PT+NEE, seed 0: frame time,
     rays traced, Grays/s, peak memory, launch counts, per-kernel time
     against its bound, and each kernel against its plain version on a
     sample of SAMPLE_PACKETS live packets of every main-path call.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Needs torch with CUDA and nvcc; imports
nothing of JAX.
"""

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
FAILED = []


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
    vr, vg = ref.valid, got.valid
    check(f"{tag} valid masks equal", bool((vr == vg).all()),
          f"({int((vr != vg).sum())} differ of {vr.numel()})")
    m = vr & vg
    tr, tg = ref.t[m], got.t[m]
    close = (tg - tr).abs() <= 2e-5 + 2e-4 * tr.abs()
    check(f"{tag} t within rtol 2e-4 atol 2e-5", bool(close.all()),
          f"(max abs diff {float((tg - tr).abs().max()) if m.any() else 0.0:.3g})")
    mism = (ref.prim[m] != got.prim[m]) & ((tr - tg).abs() > 1e-4 * tr.clamp(min=1))
    rate = float(mism.float().mean()) if m.any() else 0.0
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


def sample_packets(torch, args, k):
    """The call's inputs cut to k live packets spread evenly over its live
    packets (all of them if there are fewer), against the full pages."""
    order, packet = args[0], args[8]
    live_pk = torch.nonzero((args[4].view(-1, packet) > 0).any(dim=1)).view(-1)
    if live_pk.numel() > k:
        live_pk = live_pk[torch.linspace(0, live_pk.numel() - 1, k,
                                         device=live_pk.device).long()]
    ray_idx = (live_pk[:, None] * packet
               + torch.arange(packet, device=live_pk.device)).view(-1)
    return (order[live_pk].contiguous(),
            *[a[ray_idx].contiguous() for a in args[1:5]], *args[5:])


def bound_parts(torch, isect, kind, args, counts):
    """(ms for the operations at the fp32 peak, ms for the bytes at the memory
    rate) of one call's work; its bound is the larger.  Bytes: pages of every
    domain the call lists, the rays and the domain lists read once, the
    outputs written once.  Operations: the counted tests and node visits."""
    order, o = args[0], args[1]
    doms = torch.unique(order[order >= 0])
    page = (isect.bounds[0].numel() * 4 + isect.meta[0].numel() * 4
            + isect.w[0].numel() * 4)
    nbytes = (doms.numel() * page + o.shape[0] * (24 + 8) + order.numel() * 4
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
    from spray_tpu_torch.io.scenes import wisp_cloud
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
    for src in sorted(_build.CSRC.glob("*.cu")):
        t0 = time.perf_counter()
        _, log = _build.build(src.stem)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {src.name} into {_build.BUILD_DIR.relative_to(ROOT)}: "
              f"{time.perf_counter() - t0:.2f} s; " + " | ".join(regs), flush=True)
    traverse.reset_launches()

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
    for tag, kind, (wo, wd, wmin, wmax) in waves:
        args, _ = sisect._args(wo, wd, wmin, wmax)
        got = run_kernel(traverse, kind, args)
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

    # ---- phase 3: path parity -------------------------------------------------
    img_k = render(small, cam64, cfg64, intersector=sisect, device=dev)
    img_p = render(small, cam64, cfg64, intersector=PlainIntersector(sisect),
                   device=dev)
    torch.cuda.synchronize()
    err = float(np.abs(img_k - img_p).max())
    check("phase3 64x64 PT+NEE kernels~plain allclose(atol 2e-3, rtol 1e-3)",
          bool(np.allclose(img_k, img_p, atol=2e-3, rtol=1e-3)),
          f"(max abs {err:.3g}, mean {img_k.mean():.5f})")

    # ---- phase 4: the main path at full size --------------------------------
    t0 = time.perf_counter()
    scene = wisp_cloud(n_blobs=8, tris_per_blob=131072, seed=3)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    pages = build_cluster_domains(scene)
    t_pages = time.perf_counter() - t0
    isect = MultiDomainClusterIntersector.from_pages(scene, pages, device=dev)
    del pages
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
    traverse.reset_launches()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.run()  # synchronises the card before returning
        times.append(time.perf_counter() - t0)
    launches = dict(traverse.launches)
    img = out[0]
    rays = pipe.rays_traced(out)
    frame = min(times)
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
    for k, v in launches.items():
        check(f"phase4 {k} launched on the main path", v > 0, f"({v})")

    # per-kernel time, tests and bound at the main path's shapes
    rec = Recorder(isect)
    fn = make_render_fn(scene, cam, cfg, rec, with_stats=True, device=dev)
    fn(make_scene_arrays(scene, dev))
    torch.cuda.synchronize()
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    keys = ("ms", "bound_ms", "ops_ms", "bytes_ms", "s_ms", "s_plain_ms",
            "s_ops_ms", "s_bytes_ms", "s_err")
    stats = {k: {**dict.fromkeys(keys, 0.0), "calls": 0, "s_rays": 0,
                 "counts": np.zeros(3)} for k in ("nearest", "anyhit")}
    for i, (kind, wo, wd, wmin, wmax) in enumerate(rec.calls):
        args, _ = isect._args(wo, wd, wmin, wmax)
        counters.zero_()
        run_kernel(traverse, kind, args, counters)
        cnt = counters.cpu().numpy().astype(np.float64)
        ms = cuda_ms(torch, lambda: run_kernel(traverse, kind, args))
        parts = bound_parts(torch, isect, kind, args, cnt)
        bms, by = bound_of(*parts)
        live = int((wmax > 0).sum())
        # the kernel against its plain version on a sample of this call
        sub = sample_packets(torch, args, SAMPLE_PACKETS)
        counters.zero_()
        run_kernel(traverse, kind, sub, counters)
        s_cnt = counters.cpu().numpy().astype(np.float64)
        got = run_kernel(traverse, kind, sub)
        ref, s_plain_ms = timed_once(torch, lambda: run_plain(traverse, kind, sub))
        n_pk = sub[0].shape[0]
        err = compare_raw(f"phase4 call {i} {kind} kernel~plain on {n_pk} "
                          "main-path packets", kind, ref, got)
        s_ms = cuda_ms(torch, lambda: run_kernel(traverse, kind, sub))
        s_parts = bound_parts(torch, isect, kind, sub, s_cnt)
        print(f"phase4 call {i} {kind}: {live} live rays, {int(cnt[0])} node "
              f"visits, {int(cnt[1])} leaf visits, {int(cnt[2])} tri tests; "
              f"{ms:.3f} ms vs bound {bms:.4f} ms ({by}); sample of {n_pk} "
              f"packets {s_ms:.3f} ms vs plain {s_plain_ms:.3f} ms", flush=True)
        s = stats[kind]
        for key, val in (("ms", ms), ("ops_ms", parts[0]), ("bytes_ms", parts[1]),
                         ("bound_ms", bms), ("s_ms", s_ms),
                         ("s_plain_ms", s_plain_ms), ("s_ops_ms", s_parts[0]),
                         ("s_bytes_ms", s_parts[1])):
            s[key] += val
        s["s_err"] = max(s["s_err"], err)
        s["s_rays"] += sub[1].shape[0]
        s["calls"] += 1
        s["counts"] += cnt
    del rec

    kernels = []
    for kind, name, replaces in (
        ("nearest", "nearest_kernel", "spray_tpu/kernels/traverse.py:379"),
        ("anyhit", "anyhit_kernel", "spray_tpu/kernels/traverse.py:658"),
    ):
        s = stats[kind]
        fby = "operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes"
        bms, by = bound_of(s["s_ops_ms"], s["s_bytes_ms"])
        print(f"phase4 {name}: per frame {s['ms']:.3f} ms in {s['calls']} launches"
              f" ({launches[name] / 3:.0f} per timed frame), "
              f"{int(s['counts'][2])} tri tests, bound {s['bound_ms']:.4f} ms "
              f"({fby}); samples ({s['s_rays']} rays over {s['calls']} calls) "
              f"{s['s_ms']:.3f} ms vs plain {s['s_plain_ms']:.3f} ms, bound "
              f"{bms:.4f} ms ({by}); card {smi}", flush=True)
        kernels.append({
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
        })

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
