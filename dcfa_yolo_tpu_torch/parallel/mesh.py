"""Process groups, batch sharding and the collectives of the port's data
parallelism (`dcfa_yolo_tpu/parallel/mesh.py`, reference DDP init
`train_mul.py:115-127`).

The JAX package shards the batch axis of one program over a device mesh and
lets GSPMD insert the reductions.  The port runs one process a rank instead
(torchrun, or `run_ranks` below): each holds a full replica, loads its
even slice of every global batch (`shard_batch`) and reduces across the
group where the JAX program would (`all_reduce_sum` / `all_reduce_mean`,
differentiable).  No DDP wrapper: the trainer reduces its flat gradient
itself (`train/trainer.py`), because DDP would broadcast rank 0's BN
statistics and average per-rank-normalised losses, neither of which is the
JAX step.

`nccl` is the backend on CUDA, `gloo` on the CPU.  Gloo also reduces CUDA
tensors (through host copies), which lets several ranks share one card.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

TIMEOUT_S = 300.0  # `run_ranks`: a rank's collectives and the whole call


def init_process_group(backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       device="cuda", timeout_s: Optional[float] = None):
    """Join the default process group and return it.

    Without `init_method` the rank, world size and rendezvous come from the
    environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, as
    torchrun and the reference's DDP init set them); missing variables raise.
    `backend` defaults to `nccl` for a CUDA `device` and `gloo` for the CPU;
    a CUDA `device` with an index becomes this process's current device
    (NCCL's collectives and barriers run there).  A collective that waits
    longer than `timeout_s` fails; None keeps torch's default for the
    backend (a training run's ranks wait at a barrier while rank 0
    evaluates and writes checkpoints)."""
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"distributed training needs {', '.join(missing)} in the "
                "environment (torchrun sets them)")
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    timeout = None if timeout_s is None else datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dist.group.WORLD


def rank_device(device="cuda") -> torch.device:
    """The device of this process's rank: `cuda:LOCAL_RANK` for a CUDA
    `device` (raises where the host has fewer cards than local ranks; NCCL
    refuses two ranks on one card), else `device` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"local rank {local} has no CUDA device: this host has {n}, and "
            "each rank needs a card of its own (run at most one rank a card)")
    return torch.device("cuda", local)


def use_device(device, tf32: bool = False) -> None:
    """A spawned rank's CUDA set-up: its card, TF32 as asked, and the kernel
    library its parent built, loaded and never built here (ranks building
    at once would race).  Nothing on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    from dcfa_yolo_tpu_torch.ops import _build

    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    _build.load_library(build=False)


def world_size(group) -> int:
    """The ranks in `group`; 1 for None (no data parallelism)."""
    return 1 if group is None else dist.get_world_size(group)


def shard_batch(batch: Sequence, rank: int, world: int):
    """The rank's even slice of the batch axis of every field of `batch` (a
    tuple or NamedTuple of arrays or tensors; None fields pass through).  A
    batch the world does not divide raises, as a JAX data sharding does."""
    sizes = {len(x) for x in batch if x is not None}
    if len(sizes) != 1:
        raise ValueError(f"batch fields disagree on the batch size: {sorted(sizes)}")
    b = sizes.pop()
    if b % world:
        raise ValueError(f"a batch of {b} does not divide over {world} ranks")
    lo, hi = rank * b // world, (rank + 1) * b // world
    fields = [None if x is None else x[lo:hi] for x in batch]
    return type(batch)(*fields) if hasattr(batch, "_fields") else type(batch)(fields)


@torch.no_grad()
def broadcast_state(module: nn.Module, group, src: int = 0) -> None:
    """Overwrite, in place, the parameters and buffers of `module` with rank
    `src`'s."""
    if group is None:
        return
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t, src, group=group)


def _reduce(t: torch.Tensor, group, mean: bool) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(world_size(group)) if mean else t


class _AllReduce(torch.autograd.Function):
    """Sum (or mean) over the ranks; the backward reduces the cotangent the
    same way: each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, ctx.mean), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of `x` (`lax.psum`), differentiable; `x` itself is
    not modified.  No group: `x`."""
    return x if group is None else _AllReduce.apply(x, group, False)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks of `x` (`lax.pmean`), differentiable.  No
    group: `x`."""
    return x if group is None else _AllReduce.apply(x, group, True)


# -- W ranks as W processes on this host -------------------------------------
def run_calls(rank: int, world: int, group, calls: Sequence) -> List[Any]:
    """Each `(fn, args)` of `calls` in order on this rank, as
    `fn(rank, world, group, *args)`: several checks in one spawn."""
    return [fn(rank, world, group, *args) for fn, args in calls]


def _rank_main(rank, world, backend, init_method, device, threads, timeout_s, fn,
               args, out):
    try:
        torch.set_num_threads(threads)
        group = init_process_group(backend, init_method, rank, world, device, timeout_s)
        try:
            out.put((rank, True, fn(rank, world, group, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Iterable[Any] = (),
              backend: str = "gloo", device="cpu", threads: int = 1,
              store_dir: Optional[str] = None,
              timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run `fn(rank, world, group, *args)` on `world` spawned processes
    joined by a `file://` store (in `store_dir`, else a temporary directory)
    and return their results by rank.  `fn` must be importable (a module
    function) and return picklable values (numpy, not tensors).  A rank
    that raises or dies fails the call, and the others are stopped; so does
    a call or a rank's collective that outlasts `timeout_s`."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dcfa_store_", dir=store_dir)
    init_method = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, init_method, device, threads,
                               timeout_s, fn, tuple(args), out))
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                       f"gave no result in {timeout_s:g} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
