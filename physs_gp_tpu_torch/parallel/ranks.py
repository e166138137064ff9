"""Run a `torch.distributed` program on n ranks in spawned processes, each
call within a time limit (PyTorch).

`start_ranks(fn, n, args=..., device=..., timeout=...)` starts n processes
with the `spawn` start method, joins them into one process group at
`tcp://localhost:<free port>` and runs `fn(rank, n, *args)` in each; it
returns at once, and the `wait()` of what it returns gives the results in
rank order. `fn` must be importable (a module-level function)
and return picklable values (numbers, numpy arrays). A rank that raises
fails the call with its traceback; a call that outlives `timeout` kills
every rank and fails, so a hung rendezvous or collective ends the call
instead of hanging it.

Backends: NCCL for a single rank on the card; gloo for several ranks on
one card (NCCL refuses two ranks on one GPU) and on the CPU. Every rank runs
one CPU thread; every rank on the card uses `cuda:0`. `make_mesh` builds
the DeviceMesh inside a rank.
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["start_ranks", "make_mesh"]

# a rank whose process ended without a result fails the call after this
# grace (its result may still be in the queue's pipe)
_EXIT_GRACE_S = 5.0


def _backend(device: str, n: int) -> str:
    return "nccl" if device == "cuda" and n == 1 else "gloo"


def make_mesh(shape, names, device: str):
    """A DeviceMesh of `shape` with dimension `names` over the ranks of the
    process group, on `device` ("cuda" or "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, backend, device, arg_queue, results, timeout):
    """One rank: take fn's arguments, join the group, run fn, report (rank,
    ok, result or traceback) to the parent."""
    try:
        args = arg_queue.get(timeout=timeout)
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """n ranks started by `start_ranks`; `wait()` returns their results."""

    def __init__(self, procs, arg_queue, results, n, backend, device, timeout):
        self.procs, self.arg_queue, self.results, self.n = procs, arg_queue, results, n
        self.what = f"{n} ranks ({backend}, {device})"
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.out = None

    def wait(self) -> list:
        """The ranks' results in rank order (collected once). Raises
        RuntimeError when a rank fails, TimeoutError when the ranks have not
        all returned within the time limit (counted from the start); every
        rank is killed then."""
        if self.out is not None:
            return self.out
        n, procs = self.n, self.procs
        got, exited = {}, {}
        try:
            while len(got) < n:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{self.what}: ranks {sorted(set(range(n)) - set(got))} "
                                       f"gave no result in {self.timeout:g} s")
                try:
                    rank, ok, out = self.results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    now = time.monotonic()
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode is not None:
                            if now - exited.setdefault(r, now) > _EXIT_GRACE_S:
                                raise RuntimeError(f"{self.what}: rank {r} exited ({p.exitcode}) "
                                                   "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"{self.what}: rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            # arguments a dead rank never took must not hold this process at exit
            self.arg_queue.cancel_join_thread()
            self.arg_queue.close()
            self.results.close()
        self.out = [got[r] for r in range(n)]
        return self.out


def start_ranks(fn, n: int, *, args=(), device: str = "cuda", timeout: float = 600.0) -> Ranks:
    """Start fn(rank, n, *args) on n spawned ranks and return at once."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ranks on device 'cuda' need a CUDA device")
    ctx = mp.get_context("spawn")
    results, arg_queue = ctx.Queue(), ctx.Queue()
    port = _free_port()
    backend = _backend(device, n)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, n, port, backend, device, arg_queue, results, timeout)) for r in range(n)]
    for p in procs:
        p.start()
    # the arguments go through a queue, whose feeder thread writes them while
    # the ranks import: a start() that carried them would wait for each rank
    for _ in procs:
        arg_queue.put(args)
    return Ranks(procs, arg_queue, results, n, backend, device, timeout)

