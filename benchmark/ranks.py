"""The rank runner: a cell whose `chips` is N > 1 runs in N processes, one
rank a card, joined by the harness to one process group.

The benchmark starts its ranks itself and imports nothing of the program's
launcher (`spray_tpu_torch.dist.launch`), so that a change there cannot move
what the benchmark measures.  Each rank is a spawned process:

- its card made current (`torch.cuda.set_device(rank)`) before anything
  touches the card;
- joined to the default group (NCCL on the card, gloo with device "cpu")
  through a FileStore in a fresh temporary directory, and to a gloo group
  of the harness's own (`Lockstep`), on which rank 0 hands its decisions
  to the others without putting anything on the cards' streams;
- killed with the harness's process if that dies first (Linux's parent
  death signal), so that no rank outlives a run.

`run_world` hands back what each rank's function returned.  A rank that
raises or dies, a collective that waits past COLLECTIVE_TIMEOUT_S, or a
world that is not done after `timeout_s` ends the run with `RankFailure`;
every rank process is stopped and waited for first.
"""

from __future__ import annotations

import ctypes
import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import signal
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# a collective (the program's, or the harness's own) that waits longer fails
COLLECTIVE_TIMEOUT_S = 300.0
# a whole world, set-up to the check: the first run of a cell in a checkout
# builds every kernel
TIMEOUT_S = 1100.0
# how long a stopped rank gets to end after SIGTERM, before SIGKILL
GRACE_S = 10.0


class RankFailure(RuntimeError):
    """A rank raised, died, or the world ran past its time."""


class Lockstep:
    """Rank 0's decisions, handed to every rank over the harness's gloo
    group: host tensors only, nothing on a card's stream."""

    def __init__(self, group):
        self.group = group

    def barrier(self):
        dist.barrier(group=self.group)

    def agree(self, flag):
        """Rank 0's `flag`, on every rank (the others' own is ignored)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())


def _die_with_parent(parent_pid):
    """SIGKILL this process when the process that started it ends."""
    if sys.platform.startswith("linux"):
        pr_set_pdeathsig = 1
        ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig,
                                                 signal.SIGKILL)
    if os.getppid() != parent_pid:  # it ended before the signal was set
        os._exit(1)


def join(store_path, rank, world, device_type):
    """Join this process to the default group as `rank` of `world`, and to
    the harness's own gloo group: (this rank's device, Lockstep)."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
    # the host's cores shared out among the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=timeout)
    return device, Lockstep(dist.new_group(backend="gloo", timeout=timeout))


def _rank_main(rank, world, store_path, device_type, parent_pid, fn, args,
               results):
    _die_with_parent(parent_pid)
    try:
        device, lockstep = join(store_path, rank, world, device_type)
        out = fn(rank, world, device, lockstep, *args)
    except BaseException:
        # told first: the harness then stops every rank, this one too (its
        # group is not destroyed: that can wait on a peer that is stuck)
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()
    results.put((rank, True, out))


def _stop(procs):
    """Stop every rank process still running and wait for each to end."""
    for p in procs:
        if p.pid is not None and p.is_alive():
            p.terminate()
    for p in procs:
        if p.pid is None:
            continue
        p.join(GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def run_world(fn, world, args, device="cuda", timeout_s=TIMEOUT_S):
    """fn(rank, world, device, lockstep, *args) in `world` spawned ranks, one
    card each ("cpu": gloo ranks on the host); their results in rank order.
    fn must be a module-level function of an importable module, and args
    and what fn returns must pickle."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RankFailure(f"a world of {world} ranks needs as many CUDA cards; "
                          f"found {torch.cuda.device_count()}")
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    tmp = tempfile.mkdtemp(prefix="bench_world_")
    store = os.path.join(tmp, "store")
    procs = [mp.Process(target=_rank_main, daemon=True,
                        args=(rank, world, store, device_type, os.getpid(), fn,
                              args, results))
             for rank in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RankFailure(
                        f"rank {dead[0]} of {world} ended with exit code "
                        f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise RankFailure(f"a world of {world} ranks did not end "
                                      f"in {timeout_s} s") from None
                continue
            if not ok:
                raise RankFailure(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(GRACE_S)
    finally:
        _stop(procs)
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
