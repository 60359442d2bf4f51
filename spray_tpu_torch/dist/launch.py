"""Start a world of ranks, one process each, joined to one process group.

JAX's runtime gives one process all its devices, so the reference needs no
launcher; torch.distributed runs one process per rank.  `run_world` spawns
them with torch.multiprocessing, joins them through a FileStore in a fresh
temporary directory (no network, no port to race for) and hands back what
each rank's function returned.

A rank's function is pickled by reference, so it must live in a module the
ranks can import without side effects (the package itself, or a worker
script's module): a function of a test module would make every rank import
that test module and whatever it imports.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.device import resolve_device


TIMEOUT_S = 600.0  # a collective that waits longer fails; so does run_world


def init_rank(store_path, rank, world_size, device):
    """Join this process to the default group as `rank` of `world_size`
    through a FileStore at `store_path`: gloo for device "cpu" (one CPU
    thread per rank), NCCL on the card (the rank's card made current).
    Returns the rank's device."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def _rank_main(rank, world_size, store_path, device, fn, args, results):
    try:
        init_rank(store_path, rank, world_size, device)
        try:
            out = pickle.dumps(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- handed to the parent, re-raised there
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size, *args, device=None):
    """Run fn(rank, world_size, *args) in `world_size` spawned processes,
    each joined to one process group (`init_rank`), and return their
    results in rank order.  fn and args must pickle, and so must what fn
    returns (numpy arrays, numbers, CPU tensors).

    device None means the CUDA card (NCCL, one card per rank; it raises
    without a card), "cpu" runs gloo.  A world of one rank on the card is a
    real NCCL group.  A rank that raises has its traceback re-raised here,
    and the other ranks are stopped; so are all of them after TIMEOUT_S
    seconds.  Every rank destroys its group, even when fn raises."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"a world of {world_size} ranks needs as many CUDA "
                           f"cards; this machine has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="spray_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, store, device.type, fn,
                               args, results))
             for rank in range(world_size)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world_size} died with exit code "
                        f"{procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks did not "
                                       f"finish in {TIMEOUT_S} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.terminate()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
