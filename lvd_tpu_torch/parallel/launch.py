"""Ranks of one host in processes of torch's ``spawn`` context.

``RankPool(n, init_dir)`` starts ``n`` processes, each ``init_process_group``
of one world over a ``FileStore`` in ``init_dir`` with a timeout, and
``run(fn, *args)`` calls the module-level ``fn(*args)`` on every rank and
returns the ranks' results in rank order. A rank that raises exits with its
traceback on its stderr and a non-zero code; ``run`` then raises, as it
does when a rank has not answered within its time limit. ``close`` (or the
``with`` block's end) asks the ranks to leave, waits for them a limited
time, and kills those still alive.
"""

from __future__ import annotations

import datetime
import os
import queue
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, backend, init_file, threads, timeout, tasks, results):
    torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(init_file, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        results.put((rank, fn(*args)))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, n: int, init_dir: str, backend: str = "gloo", threads: int = 1,
                 timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        init_file = os.path.join(init_dir, "rank_pool_store")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, n, backend, init_file, threads, timeout,
                                        self.tasks[r], self.results))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = None):
        """``fn(*args)`` on every rank; the results in rank order."""
        for q in self.tasks:
            q.put((fn, args))
        deadline = time.monotonic() + (timeout or self.timeout)
        got = {}
        while len(got) < self.n:
            dead = [r for r, p in enumerate(self.procs) if p.exitcode is not None]
            if dead:
                raise RuntimeError(f"rank(s) {dead} exited (codes "
                                   f"{[self.procs[r].exitcode for r in dead]}) during "
                                   f"{fn.__name__}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(set(range(self.n)) - set(got))}"
                                   f" did not answer in {timeout or self.timeout} s")
            try:
                rank, value = self.results.get(timeout=0.5)
            except queue.Empty:
                continue
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def close(self, timeout: float = 30.0) -> None:
        for p, q in zip(self.procs, self.tasks):
            if p.exitcode is None:
                q.put(None)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
                p.join(5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
