"""The ranks of a data-parallel cell: this process as rank 0 on card 0,
the others processes of a driver's own file on cards 1..W−1, joined by
NCCL (gloo on the CPU) over `tcp://localhost` and by a gloo group for the
driver's messages.

The world outlives a run and is kept here, one a process (a driver's
module is loaded afresh for each run of the harness), so that
`calibrate.py` and the CPU tests run many seeds on one world.  The ranks
stop when this process exits, and by themselves if it dies.

On cards each rank runs one host thread of PyTorch's own (torchrun's
`OMP_NUM_THREADS=1`) on cores of its own (`pin`): the eager step is
host-bound on every rank, and the step waits for the slowest, so ranks
that share cores, or idle worker threads that spin on them, slow the
whole world by a different amount in every process.
"""

from __future__ import annotations

import atexit
import ctypes
import datetime
import os
import signal
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

CORES = sorted(os.sched_getaffinity(0))  # this process's cores before any `pin`
TIMEOUT_S = 600.0        # a collective of the step
IDLE_TIMEOUT_S = 3600.0  # a rank waiting for its next job


class Ranks:
    """This process's place in the world: rank, world, device, the step's
    group and the driver's gloo group."""

    def __init__(self, rank, world, dev, gloo):
        self.rank, self.world, self.dev, self.gloo = rank, world, dev, gloo
        self.group = dist.group.WORLD

    def gather(self, t: torch.Tensor):
        """Rank 0: every rank's `t` on the host, joined along the batch axis
        in rank order; the others: None."""
        t = t.detach().cpu().contiguous()
        raw = t.view(torch.uint8)  # as bytes: gloo gathers no bfloat16
        parts = [torch.empty_like(raw) for _ in range(self.world)] if self.rank == 0 else None
        dist.gather(raw, parts, dst=0, group=self.gloo)
        return None if self.rank else torch.cat(parts).view(t.dtype)

    def gather_object(self, obj):
        """Rank 0: every rank's `obj` in rank order; the others: None."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.gloo)
        return out

    def flag(self, value: bool = False) -> bool:
        """Rank 0's `value` on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.gloo)
        return bool(t.item())

    def job(self, job=None):
        """Rank 0's `job` on every rank (None: stop)."""
        box = [job]
        dist.broadcast_object_list(box, 0, group=self.gloo)
        return box[0]


def cores_of(rank: int, world: int, cores=CORES):
    """Rank `rank`'s share of `cores`: an even slice in rank order (the
    four-card machine lists no cores as local to any card)."""
    k = len(cores) // world
    return list(cores[rank * k:(rank + 1) * k]) if k else [cores[rank % len(cores)]]


def pin(rank: int, world: int):
    """One PyTorch host thread, on this rank's cores (`cores_of`); returns
    what `unpin` restores."""
    saved = (torch.get_num_threads(), os.sched_getaffinity(0))
    torch.set_num_threads(1)
    os.sched_setaffinity(0, cores_of(rank, world))
    return saved


def unpin(saved) -> None:
    torch.set_num_threads(saved[0])
    os.sched_setaffinity(0, saved[1])


def join(rank: int, world: int, port: int, dev) -> Ranks:
    """Join the world's process group (NCCL on cards, gloo on the CPU) and
    its gloo group; on a card, TF32 allowed (the training CLI's bf16
    setting)."""
    from dcfa_yolo_tpu_torch.parallel.mesh import init_process_group

    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    init_process_group(None, f"tcp://localhost:{port}", rank, world, dev, TIMEOUT_S)
    gloo = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
    return Ranks(rank, world, dev, gloo)


class World:
    """The ranks this process leads: `script --rank r --world W --port p
    --device cuda|cpu` for r in 1..W−1, each running `serve`."""

    def __init__(self, script: str, ranks: int, dev):
        self.script, self.procs, self.clean = script, [], False
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if dev.type == "cuda":
            from dcfa_yolo_tpu_torch.ops import _build

            _build.load_library()  # built here once; the ranks load it
        # the ranks import what this process imports; one OpenMP thread on a card
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        if dev.type == "cuda":
            env["OMP_NUM_THREADS"] = "1"
        for r in range(1, ranks):
            self.procs.append(subprocess.Popen(
                [sys.executable, script, "--rank", str(r), "--world", str(ranks),
                 "--port", str(port), "--device", dev.type], stdout=2, env=env))
        self.rk = join(0, ranks, port, dev)
        atexit.register(self.close)

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def close(self) -> None:
        """Stop the ranks: told to where the last run ended on every rank
        (each then exits at once, leaving its groups to the operating
        system), else killed."""
        if self.clean:
            try:
                self.rk.job(None)
            except Exception:  # noqa: BLE001  the ranks are stopped below all the same
                self.clean = False
        for p in self.procs:
            try:
                p.wait(timeout=20 if self.clean else 0.1)
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        self.procs = []
        if dist.is_initialized():
            dist.destroy_process_group()
        self.clean = False


_WORLD = None


def world(script: str, ranks: int, dev) -> World:
    """This process's world of `ranks` ranks running `script`, started or
    kept from an earlier run."""
    global _WORLD
    w = _WORLD
    if w is None or not w.alive() or w.rk.world != ranks or w.script != script \
            or not w.clean and w.procs:
        if w is not None:
            w.close()
        w = _WORLD = World(script, ranks, dev)
    return w


def serve(argv, run_job) -> int:
    """A rank other than 0: join, then `run_job(ranks, job)` for every job
    rank 0 sends until it sends None."""
    import argparse

    p = argparse.ArgumentParser(description="A rank of a data-parallel cell.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = p.parse_args(argv)
    # killed with rank 0's process (Linux's PR_SET_PDEATHSIG)
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    if args.device == "cuda":
        from dcfa_yolo_tpu_torch.ops import _build

        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        pin(args.rank, args.world)
        _build.load_library(build=False)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    rk = join(args.rank, args.world, args.port, dev)
    while True:
        job = rk.job()
        if job is None:
            break
        run_job(rk, job)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)  # no teardown of the groups: NCCL's would wait for rank 0's
