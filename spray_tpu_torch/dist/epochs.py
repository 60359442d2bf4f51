"""The in-situ distributed epoch renderer (counterpart of
``spray_tpu/dist/epochs.py``).

  - IN-SITU ownership: rank p permanently holds domains [p*Dl, (p+1)*Dl)
    on its device.  Rays move to data, never data to rays.
  - Each epoch, every ray's nearest unprocessed overlapped domain names an
    OWNER rank; up to `bucket` rays per (source, owner) pair are packed
    into a fixed-shape buffer and exchanged with ONE `all_to_all_single`
    (equal splits of `bucket` rows per rank).  Overflow rays stay queued
    for a later epoch.  The send layout (each ray's slot: its owner's
    bucket, at its rank in lane order among that owner's rays) is one
    call of `kernels.route.route_slots`, the CUDA `route_slots_kernel` on
    the card (the reference's one-hot cumsum is a serial scan there).
  - The owner traces its arrivals against ALL its resident domains with the
    ray's best-t window (speculation), so the home rank marks the owner's
    whole domain range processed when the results come back through the
    inverse `all_to_all_single`.
  - Liveness is one `all_reduce` a round.  The reference's loop is a
    lax.while_loop; here it is a host loop, and its condition reads the
    global count once every `rounds_per_check` rounds: that read is the
    loop's host sync, counted in `dist.collectives["host_syncs"]`.

While a profiler records, a round's stretches are the spans (`trace`)
`spray.dist.route` (the nearest unprocessed domain, its owner and the
send slots), `.exchange` (each `all_to_all`), `.trace` (the owner's local
trace), `.commit` (the home-side update) and `.reduce` (the liveness
`all_reduce`); a frame's image and ray count are gathered in
`spray.dist.gather`; each host read is a `spray.sync.dist`.  A call adds
its rounds to the counter `dist_rounds` and its rays exchanged (the
device sum the loop already keeps) to `rays_exchanged`.

The needed-domain and nearest-needed rules of a round and the one-page
trace are `sched/multidomain.py`'s, shared with the out-of-core scheduler.
The local trace runs the CUDA cluster kernels one resident page at a time
(`_local_trace_cluster`: `PageWave`, the slot kernel or the any-hit kernel
on a one-entry list, one launch per page), or the batched-torch BVH walk
of each resident domain (`_local_trace`, backend "jnp", the cross-check).
A world of one rank still runs every collective through its group.

JAX drops the writes of empty send slots by pointing them out of range
(`mode="drop"`); torch's scatters raise there instead, so an empty slot
holds m and the home state carries one spare row (index m) that takes
those writes and is never read back into a real ray.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import trace
from ..core.types import Hits
from ..diff import DetachedIntersector, diff_scene_arrays, grads_of, scene_consts
from ..integrators import wavefront
from ..kernels import route, traverse
from ..kernels.common import tile_swizzle_order
from ..sched.multidomain import (
    BVH_FIELDS, DeviceDomainSet, PageWave, domain_bvh, domain_entries,
    nearest_needed, needed, trace_domain,
)
from . import all_gather, all_reduce, all_to_all, collectives
from .rayshard import mesh_for


def _local_trace(local, leaf_size, o, d, tmin, window, any_hit):
    """BVH local trace (backend "jnp", the cross-check): this rank's
    resident domains in order, each walked by `trace_domain` with the
    window narrowed to the best t so far.  local: dict of (Dl, ...) BVH
    fields.  Returns (t, prim, found)."""
    n = o.shape[0]
    bt = window
    bp = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    found = torch.zeros(n, dtype=torch.bool, device=o.device)
    for k in range(local["v0"].shape[0]):
        dbvh = domain_bvh({f: v[k] for f, v in local.items()}, leaf_size)
        win = torch.where(found & any_hit, torch.zeros_like(bt), bt)
        t, p, _, _, f = trace_domain(dbvh, o, d, tmin, win, any_hit=any_hit)
        upd = f if any_hit else f & (t < bt)
        if not any_hit:
            bt = torch.where(upd, t, bt)
        bp = torch.where(upd, p, bp)
        found = found | f
    return bt, bp, found


def _local_trace_cluster(pages, depth, o, d, tmin, window, any_hit):
    """Cluster-kernel local trace: the arrivals padded to whole packets
    once (`PageWave`), then one launch per resident page, in page order:
    the slot kernel for nearest, the any-hit kernel on a one-entry list for
    occlusion (a found ray's window is empty).  The update is strict (t <
    best t), so the first page wins a tie.  pages: dict of (Dl, ...)
    tensors {bounds, meta, w, tri_ids} with GLOBAL tri ids.  Returns (t,
    prim, found)."""
    n = o.shape[0]
    wave = PageWave(o, d, tmin, window)
    bt = window
    bp = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    found = torch.zeros(n, dtype=torch.bool, device=o.device)
    for j in range(pages["w"].shape[0]):
        page = {k: v[j] for k, v in pages.items()}
        if any_hit:
            found = found | wave.trace(page, ~found, bt, True, depth)
            continue
        t, prim = wave.trace(page, None, bt, False, depth)
        f = prim >= 0
        upd = f & (t < bt)
        bt = torch.where(upd, t, bt)
        bp = torch.where(upd, prim, bp)
        found = found | f
    return bt, bp, found


class CollectiveEpochIntersector:
    """Intersector whose intersect and occluded are COLLECTIVE: every rank
    of the mesh must call them together, with its own shard of rays (the
    same count on every rank).  Domain geometry is this rank's resident
    slice of the stacked pages."""

    def __init__(self, local_domains, aabb_lo, aabb_hi, owner_of_domain, mesh,
                 bucket, leaf_size, max_epochs=64, backend="cluster",
                 depth=None, tri_soa=None, rounds_per_check=1):
        if backend not in ("cluster", "jnp"):
            raise ValueError(f"backend: want 'cluster' or 'jnp', got {backend!r}")
        self.local_domains = local_domains  # dict of (Dl, ...) tensors
        self.boxes = DeviceDomainSet(aabb_lo, aabb_hi)  # (D, 3), replicated
        self.owner = owner_of_domain  # (D,) int64 replicated
        self.mesh = mesh
        self.bucket = bucket
        self.leaf_size = leaf_size
        self.max_epochs = max_epochs
        self.backend = backend
        self.depth = depth  # tree depth of the cluster pages
        self.rounds_per_check = max(1, int(rounds_per_check))
        # replicated (v0, e1, e2) for the home-side attribute recompute:
        # u and v never ride the all_to_all
        self.tri_soa = tri_soa
        # (epochs, rays exchanged) of each call since reset_stats; the
        # bounce loop is a Python loop, so the counts are plain values
        self._stat_log = []

    def reset_stats(self):
        self._stat_log = []

    def drain_stats(self):
        """(epochs: int, rays exchanged: int64 tensor) summed over the
        calls since reset_stats, which are then forgotten."""
        epochs = sum(e for e, _ in self._stat_log)
        exchanged = sum((x for _, x in self._stat_log),
                        torch.zeros((), dtype=torch.int64,
                                    device=self.owner.device))
        self._stat_log = []
        return epochs, exchanged

    def _trace(self, o, d, tmin, win, any_hit):
        if self.backend == "cluster":
            return _local_trace_cluster(self.local_domains, self.depth, o, d,
                                        tmin, win, any_hit)
        return _local_trace(self.local_domains, self.leaf_size, o, d, tmin,
                            win, any_hit)

    @torch.no_grad()
    def _epoch_loop(self, o, d, tmin, tmax, any_hit):
        ndev, b, m = self.mesh.size, self.bucket, o.shape[0]
        dev = o.device
        slots = ndev * b
        with trace.span("spray.dist.route"):
            entry = domain_entries(self.boxes, o, d, tmin, tmax)  # (m, D)
            # home state: m rays and one spare row (index m) for dropped
            # writes
            best_t = torch.cat([tmax, tmax.new_zeros(1)])
            best_prim = torch.full((m + 1,), -1, dtype=torch.int32,
                                   device=dev)
            found = torch.zeros(m + 1, dtype=torch.bool, device=dev)
            processed = torch.zeros((m + 1, entry.shape[1]), dtype=torch.bool,
                                    device=dev)
            # slot s goes to rank s // b: that owner's domains
            owner_doms = self.owner[None, :] == (
                torch.arange(slots, device=dev) // b)[:, None]
            exchanged = torch.zeros((), dtype=torch.int64, device=dev)

        def need_now():
            return needed(entry, processed[:m], best_t[:m], found[:m],
                          any_hit)

        def round_():
            nonlocal exchanged
            with trace.span("spray.dist.route"):
                # the nearest needed domain, the first of a tie
                nearest_dom, has, _ = nearest_needed(need_now(), entry)
                dest = torch.where(has, self.owner[nearest_dom], ndev)
                # <= b rays per owner, in lane order: slot owner * b + the
                # ray's rank among those with its owner (`route_slots_kernel`);
                # empty slots hold m: the spare state row
                send = route.route_slots(dest, ndev, b)
                valid = send < m
                src = torch.clamp(send, max=m - 1)
                win = torch.where(valid, best_t[send], 0.0)
                rows = torch.cat(
                    [o[src], d[src], tmin[src][:, None], win[:, None]], dim=1)
            with trace.span("spray.dist.exchange"):
                rays = all_to_all(rows, self.mesh)
            with trace.span("spray.dist.trace"):
                t, p, f = self._trace(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                                      rays[:, 7].contiguous(), any_hit)
                # t's bits, prim and the found flag as int32: one exchange
                # back
                rows = torch.stack([t.view(torch.int32), p.to(torch.int32),
                                    f.to(torch.int32)], dim=1)
            with trace.span("spray.dist.exchange"):
                back = all_to_all(rows, self.mesh)
            with trace.span("spray.dist.commit"):
                tt, pp = back[:, 0].view(torch.float32), back[:, 1]
                hit = (back[:, 2] != 0) & valid
                cur_t = best_t[send]
                upd = hit & (tt < cur_t)
                best_t[send] = torch.where(upd, tt, cur_t)
                best_prim[send] = torch.where(upd, pp, best_prim[send])
                found[send] = found[send] | hit
                processed[send] = processed[send] | (valid[:, None]
                                                     & owner_doms)
            with trace.span("spray.dist.reduce"):
                counts = torch.stack([need_now().any(dim=1).sum(), valid.sum()])
                all_reduce(counts, self.mesh)
                exchanged = exchanged + counts[1]
            return counts[0]

        with trace.span("spray.dist.reduce"):
            need = all_reduce(need_now().any(dim=1).sum().reshape(1),
                              self.mesh)[0]
        collectives["host_syncs"] += 1
        with trace.sync("dist"):
            need = int(need)
        epoch = 0
        while epoch < self.max_epochs and need > 0:
            # rounds_per_check rounds per read of the global count; a round
            # after convergence moves empty buckets and changes nothing
            for _ in range(self.rounds_per_check):
                global_need = round_()
                epoch += 1
            collectives["host_syncs"] += 1
            with trace.sync("dist"):
                need = int(global_need)
        self._stat_log.append((epoch, exchanged))
        trace.count("dist_rounds", epoch)
        trace.count("rays_exchanged", exchanged)
        return {"best_t": best_t[:m], "best_prim": best_prim[:m],
                "found": found[:m]}

    def _hits_from_state(self, s, o, d, tmax):
        if self.tri_soa is not None:
            # (t, u, v) recomputed at HOME against the committed triangle
            v0, e1, e2 = self.tri_soa
            t, u, v, valid = traverse.attrs_for_prims(
                v0, e1, e2, s["best_prim"], o, d, s["best_t"], tmax)
            return Hits(t=torch.where(valid, t, tmax), prim=s["best_prim"],
                        u=u, v=v, valid=valid)
        return Hits(t=torch.where(s["found"], s["best_t"], tmax),
                    prim=s["best_prim"], u=torch.zeros_like(tmax),
                    v=torch.zeros_like(tmax), valid=s["found"])

    def intersect(self, o, d, tmin, tmax):
        s = self._epoch_loop(o, d, tmin, tmax, any_hit=False)
        return self._hits_from_state(s, o, d, tmax)

    def occluded(self, o, d, tmax):
        s = self._epoch_loop(o, d, torch.zeros_like(tmax), tmax, any_hit=True)
        return s["found"]


def _insitu_setup(scene, mesh, n_domains, leaf_size=8, backend="cluster"):
    """The domain partition rounded up to a multiple of the world size, this
    rank's resident slice of the stacked pages on its device, and the
    replicated domain boxes, owner map and (cluster) triangle SoA.  Every
    rank builds the whole partition on the host, identically, and keeps
    only its slice (the reference's in-situ 'data produced in place')."""
    ndev, dev = mesh.size, mesh.device
    if n_domains is None:
        n_domains = max(ndev, 8)
    n_domains = -(-n_domains // ndev) * ndev
    per = n_domains // ndev
    owner = np.arange(n_domains, dtype=np.int64) // per
    depth, tri_soa = None, None
    if backend == "cluster":
        from ..kernels.multidomain import build_cluster_domains  # noqa: PLC0415

        st = build_cluster_domains(scene, n_domains)
        if st["bounds"].shape[0] != n_domains:
            raise ValueError(f"partitioner produced {st['bounds'].shape[0]} "
                             f"non-empty domains != requested {n_domains}")
        stacked = {k: st[k] for k in ("bounds", "meta", "w")}
        stacked["tri_ids"] = np.asarray(st["tri_ids"], np.int64)
        aabb_lo, aabb_hi = st["aabb"][:, 0:3], st["aabb"][:, 3:6]
        tri_soa = traverse.tri_soa_from_scene(scene, dev)
    elif backend == "jnp":
        from ..domains.partition import partition_scene  # noqa: PLC0415

        dset = partition_scene(scene, n_domains, leaf_size=leaf_size)
        stacked = {k: getattr(dset, k) for k in BVH_FIELDS}
        aabb_lo, aabb_hi = dset.aabb_lo, dset.aabb_hi
    else:
        raise ValueError(f"backend: want 'cluster' or 'jnp', got {backend!r}")
    lo = mesh.rank * per
    local = {k: torch.as_tensor(np.ascontiguousarray(v[lo:lo + per]), device=dev)
             for k, v in stacked.items()}
    if backend == "cluster":
        depth = traverse.tree_depth(stacked["meta"][lo:lo + per])

    def rep(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    return {"ndev": ndev, "n_domains": n_domains, "local": local,
            "depth": depth, "aabb_lo": rep(aabb_lo), "aabb_hi": rep(aabb_hi),
            "owner": rep(owner), "tri_soa": tri_soa, "leaf_size": leaf_size,
            "backend": backend}


def _intersector(su, mesh, bucket, max_epochs, tri_soa):
    return CollectiveEpochIntersector(
        su["local"], su["aabb_lo"], su["aabb_hi"], su["owner"], mesh, bucket,
        su["leaf_size"], max_epochs, backend=su["backend"], depth=su["depth"],
        tri_soa=tri_soa)


def _insitu_pixels(camera, ndev):
    """Tile-swizzled pixel order padded to the world size (pads re-render
    pixel 0; callers mask or overwrite them): (npix, pad, order)."""
    npix = camera.width * camera.height
    order = tile_swizzle_order(camera.width, camera.height)
    pad = (-npix) % ndev
    return npix, pad, np.concatenate([order, np.zeros(pad, np.uint32)])


def _rank_pixels(order, mesh):
    """This rank's shard of the padded order: (numpy ids, int64 tensor)."""
    m = order.shape[0] // mesh.size
    mine = order[mesh.rank * m:(mesh.rank + 1) * m]
    return mine, torch.as_tensor(mine.astype(np.int64), device=mesh.device)


def make_insitu_renderer(scene, camera, cfg, mesh=None, n_domains=None,
                         bucket=4096, leaf_size=8, max_epochs=64,
                         backend="cluster", device=None):
    """Fully distributed renderer: pixels sharded, domains sharded (in
    situ), epochs exchange rays between the ranks.  Returns render(seed=None)
    -> the (H, W, 3) numpy image on every rank; render.local(seed=None) ->
    this rank's (pixel ids, radiance); both collective.  After each call
    render.last_stats holds trace_activations (summed over the ranks),
    epochs and rays_exchanged (summed over the samples).

    A call renders the frame of `cfg`, or with `seed` that of
    `dataclasses.replace(cfg, seed=seed)`: new samples over the same
    partition, pages and scene arrays, built once here, the image
    bit-equal to a renderer built with that seed.  Every rank passes the
    same seed, as it makes the call.

    backend "cluster" (default) traces with the CUDA cluster kernels (their
    plain versions on the CPU); "jnp" walks per-domain BVHs in batched
    torch (the cross-check)."""
    mesh = mesh_for(mesh, device)
    su = _insitu_setup(scene, mesh, n_domains, leaf_size, backend)
    npix, pad, order = _insitu_pixels(camera, mesh.size)
    mine, pix = _rank_pixels(order, mesh)
    arrays = wavefront.scene_arrays_for(scene, mesh.device)

    def run(seed):
        frame = cfg if seed is None else dataclasses.replace(cfg, seed=seed)
        inter = _intersector(su, mesh, bucket, max_epochs, su["tri_soa"])
        acc = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                          device=mesh.device)
        nrays = torch.zeros((), dtype=torch.int64, device=mesh.device)
        epochs, exchanged = 0, 0
        for s in range(frame.spp):
            inter.reset_stats()
            rad, nr = wavefront.sample_wavefront(arrays, camera, frame, inter,
                                                 s, pix, with_stats=True)
            e, x = inter.drain_stats()
            acc, nrays = acc + rad, nrays + nr
            epochs, exchanged = epochs + e, exchanged + x
        with trace.span("spray.glue.accumulate"):
            with trace.span("spray.dist.gather"):
                all_reduce(nrays, mesh)
            with trace.sync("dist"):
                render.last_stats = {"trace_activations": int(nrays),
                                     "epochs": int(epochs),
                                     "rays_exchanged": int(exchanged)}
            return acc / float(frame.spp)

    def render(seed=None):
        with trace.span("spray.frame"):
            acc = run(seed)
            with trace.span("spray.glue.accumulate"):
                with trace.span("spray.dist.gather"):
                    acc = all_gather(acc, mesh)
                with trace.sync("dist"):
                    acc = acc.cpu().numpy()
                img = np.zeros((npix + pad, 3), np.float32)
                img[order] = acc
            return img[:npix].reshape(camera.height, camera.width, 3)

    def render_local(seed=None):
        """This rank's (pixel ids, radiance): its shard of the frame of
        `seed` (see make_insitu_renderer)."""
        with trace.span("spray.frame"):
            acc = run(seed)
            with trace.sync("dist"):
                return mine, acc.cpu().numpy()

    render.last_stats = None
    render.local = render_local
    return render


def make_insitu_diff_fn(scene, camera, cfg, mesh=None, n_domains=None,
                        bucket=4096, max_epochs=64,
                        loss_weights=(0.4, 0.8, 1.3), device=None):
    """Differentiable DOMAIN-SHARDED renderer.  Returns step(params) ->
    (loss, grads), the same on every rank (collective).

    Forward: the collective epoch loop (no autograd) commits discrete prim
    ids per ray at home.  Backward: `DetachedIntersector` re-intersects the
    committed prims at home against the live vertices, shading reads the
    live albedo and emission, and autograd runs locally; then one
    all_reduce per gradient tensor and one for the loss.  loss =
    mean(image * loss_weights), as the single-device pipeline's: the
    padded lanes (which re-render pixel 0) are masked out of it."""
    mesh = mesh_for(mesh, device)
    su = _insitu_setup(scene, mesh, n_domains, backend="cluster")
    npix, _, order = _insitu_pixels(camera, mesh.size)
    _, pix = _rank_pixels(order, mesh)
    m = pix.shape[0]
    lane_valid = (mesh.rank * m + torch.arange(m, device=mesh.device)) < npix
    consts = scene_consts(scene, mesh.device)
    w = torch.tensor(loss_weights, dtype=torch.float32, device=mesh.device)

    def step(params):
        p = {k: torch.as_tensor(v, device=mesh.device).detach()
             .requires_grad_(True) for k, v in params.items()}
        arrays, vertices, faces = diff_scene_arrays(scene, p, consts)
        inter = _intersector(su, mesh, bucket, max_epochs, None)
        dinter = DetachedIntersector(inter, vertices, faces)
        acc = 0.0
        for s in range(cfg.spp):
            acc = acc + wavefront.sample_wavefront(arrays, camera, cfg, dinter,
                                                   s, pix)
        img = acc / float(cfg.spp)
        contrib = torch.where(lane_valid[:, None], img * w, 0.0)
        loss = torch.sum(contrib) / float(npix * 3)
        grads = grads_of(loss, p)
        for g in grads.values():
            all_reduce(g, mesh)
        return all_reduce(loss.detach(), mesh), grads

    return step
