"""Device mesh over ``torch.distributed`` — port of
fast_lio_sam_qn_tpu/parallel/mesh.py.

The reference shards three data-parallel surfaces of the SLAM problem over
a ``jax.sharding.Mesh`` from one controlling process (``shard_map``).  Here
the mesh is multi-process SPMD: one process (rank) per member, each holding
the replicated state (store, graph, pipeline) and computing its contiguous
block of a sharded axis (``shard_rows``, what ``P(axis)`` is on a leading
axis); the collectives combine the blocks, so that every rank takes each
decision from the same bits.

- ``all_reduce_sum`` gathers every rank's part and adds the parts in rank
  order, so every rank computes the same sum bit for bit whatever order
  the backend would reduce in.
- ``all_gather_rows`` concatenates the ranks' blocks in rank order.

The backend is the caller's choice, never a fallback: ``"nccl"`` where each
rank has a card of its own, ``"gloo"`` for CPU ranks and for several ranks
that share one card.  With gloo a CUDA tensor is copied to host memory,
exchanged and copied back: that copy is the transport.  Every process
group gets a timeout, so a rank that is left alone in a collective fails
the run instead of hanging it.

``run_ranks`` starts the ranks of one program as spawned processes (the
tests' gloo ranks, and several ranks sharing one card); a command-line run
starts them with ``torchrun`` instead, which sets the rendezvous in the
environment (``make_mesh`` with ``init_method=None``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
import uuid
from dataclasses import dataclass
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 300.0  # a collective waiting longer than this fails the run


@dataclass
class Mesh:
    """One rank's view of the mesh: the world size, this process's rank and
    device, and the backend of the process group.  ``collective_s`` and
    ``collectives`` count the host seconds spent in, and the number of,
    its collectives (for gloo on a CUDA tensor: the exchange and the copy
    back, not the wait for the device work queued before it; for nccl:
    the enqueue)."""

    size: int
    rank: int
    device: torch.device
    backend: str
    collective_s: float = 0.0
    collectives: int = 0

    def shard_rows(self, n: int) -> slice:
        """This rank's contiguous block of a leading axis of length n,
        which the world size must divide."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} rows does not divide "
                             f"over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def _gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        staged = self.backend == "gloo" and t.device.type == "cuda"
        x = (t.cpu() if staged else t).contiguous()
        t0 = time.perf_counter()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        if staged:
            parts = [p.to(t.device) for p in parts]
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return parts

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (equal shapes) concatenated on the leading axis
        in rank order."""
        return torch.cat(self._gather(t))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t, added in rank order."""
        parts = self._gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def close(self) -> None:
        dist.destroy_process_group()


def make_mesh(n: int, *, device: torch.device | str, backend: str,
              init_method: str | None = None, rank: int | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the n-rank process group of this program and return this
    rank's Mesh.  With ``init_method=None`` the rendezvous, the world size
    and the rank come from the environment as ``torchrun`` sets them
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise
    from ``init_method`` (``file://`` or ``tcp://localhost:<port>``) and
    ``rank``.  A world size other than n raises ValueError, as the
    reference's "need n devices" does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device, not {device}")
    if init_method is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != n:
            raise ValueError(f"need {n} ranks, the environment has "
                             f"WORLD_SIZE={world}")
        rank = int(os.environ["RANK"]) if n > 1 else 0
        init_method = "env://" if n > 1 else None
    elif rank is None:
        raise ValueError("an explicit init_method needs the rank")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:  # one rank and no rendezvous: a store of its own
        store = dist.HashStore()
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(size=n, rank=rank, device=device, backend=backend)


def _rank_entry(fn, rank, devices, backend, rendezvous, out, args, threads,
                timeout_s):
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(len(devices), device=devices[rank], backend=backend,
                         init_method=f"file://{rendezvous}", rank=rank,
                         timeout_s=timeout_s)
        try:
            result = fn(mesh, *args)
        finally:
            mesh.close()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except Exception:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, devices, *, backend: str, workdir: str, args=(),
              timeout_s: float = 120.0, threads: int | None = None) -> list:
    """``fn(mesh, *args)`` on ``len(devices)`` spawned processes, rank r on
    ``devices[r]``, the rendezvous a new file in ``workdir``; returns each
    rank's return value in rank order.  ``fn`` must be importable (a
    module-level function) and its arguments and result picklable.  A rank
    that fails raises RuntimeError with its traceback; a run longer than
    ``timeout_s`` raises TimeoutError; every process is stopped before this
    returns or raises.  ``threads`` sets each rank's torch threads."""
    ctx = torch.multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex
    rendezvous = os.path.join(workdir, f"rendezvous-{tag}")
    outs = [os.path.join(workdir, f"rank{r}-{tag}.pkl")
            for r in range(len(devices))]
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, r, list(devices), backend, rendezvous, outs[r], tuple(args),
        threads, timeout_s)) for r in range(len(devices))]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        pending = {p.sentinel: (r, p) for r, p in enumerate(procs)}
        while pending:
            left = deadline - time.monotonic()
            ready = wait(list(pending), timeout=max(left, 0.0))
            if not ready:
                raise TimeoutError(f"ranks {sorted(r for r, _ in pending.values())} "
                                   f"still running after {timeout_s:.0f} s")
            for s in ready:
                r, p = pending.pop(s)
                p.join()
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with {p.exitcode}:\n"
                                       f"{_read(outs[r])[1]}")
        results = []
        for r, path in enumerate(outs):
            status, value = _read(path)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        for path in outs:
            if os.path.exists(path):
                os.remove(path)


def _read(path: str):
    if not os.path.exists(path):
        return "error", "(no result written)"
    with open(path, "rb") as f:
        return pickle.load(f)
