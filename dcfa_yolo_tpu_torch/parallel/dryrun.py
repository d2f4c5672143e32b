"""Data-parallel dry run and the per-rank steps behind it
(`__graft_entry__.py:33-112`, `dryrun_multichip`):

    python -m dcfa_yolo_tpu_torch.parallel.dryrun N [--step-mode fused|split]
        [--device cpu]

spawns N ranks (`parallel/mesh.py::run_ranks`; NCCL and one card a rank on
CUDA, gloo on the CPU).  Each runs one full-model train step at phi='n' 32²
(two images a rank) in each step mode, or in the one asked for, then the
fused check (`parallel/fused_check.py`: the BN moments of the global
batch), and prints one line per rank and mode.

`train_rank`, `stem_rank` and `aug_rank` are what a rank runs;
chip_smoke.py and the tests spawn them through `run_ranks` with the inputs
they compare.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks, shard_batch, use_device

DRY_HW = (32, 32)


def _numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy().copy() for k, v in d.items()}


def _digest(st) -> str:
    """A digest of a TrainState's tensors and counters, bit for bit."""
    h = hashlib.sha256()
    for d in (st.params, st.batch_stats, st.ema, *st.opt_state.values()):
        for k, v in (sorted(d.items()) if isinstance(d, dict) else [("", d)]):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes() if torch.is_tensor(v)
                     else repr(v).encode())
    h.update(repr(st.ema_updates).encode())
    return h.hexdigest()


def train_rank(rank: int, world: int, group, spec: Dict) -> Dict:
    """Train steps of the full model on one rank.  `spec`: `cfg` (ModelConfig
    fields), `state_dict` (numpy, the train graph's) or `seed` (the reference
    init), `batch` (host arrays: the global batch, or this rank's own with
    `per_rank`), `step_mode`, `steps`, `lr`, and optionally `tc`
    (TrainConfig fields), `device`, `tf32`, `grad` (return the
    first step's flat gradient) and `eval` (the first step's `eval_step`
    loss terms).  Returns the loss terms per step, host ms per step, the
    kernels' launches, a digest of the whole state after each step (equal
    on every rank), and the parameters, BN statistics and EMA after the
    first step as numpy state_dicts."""
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
    from dcfa_yolo_tpu_torch.ops import _build
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    started = time.time()
    dev = torch.device(spec.get("device", "cpu"))
    use_device(dev, spec.get("tf32", False))
    cfg = ModelConfig(**spec["cfg"])
    if spec.get("state_dict") is not None:
        model = DCFAYolo(cfg)
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in spec["state_dict"].items()}, strict=True)
    else:
        model = init_model(cfg, spec.get("seed", 0), dev, train=True)
    tr = Trainer(model, TrainConfig(**spec.get("tc", {})), device=dev,
                 step_mode=spec.get("step_mode", "auto"), group=group)
    local = spec["batch"] if spec.get("per_rank") else shard_batch(spec["batch"], rank, world)
    batch = tr.put_batch(*local[:5])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    before = _build.launches()
    out = dict(terms=[], step_ms=[], digests=[], step_mode=tr.step_mode,
               train_stem=tr.train_stem, started=started)
    for i in range(spec.get("steps", 1)):
        sync()
        t0 = time.perf_counter()
        lb, g = tr.step_with_grad(batch, spec.get("lr", 1e-2))
        out["terms"].append([float(t) for t in lb])  # synchronises
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        st = tr.state
        out["digests"].append(_digest(st))
        if i == 0:
            out.update(grad=g.cpu().numpy().copy() if spec.get("grad") else None,
                       params=_numpy(st.params), batch_stats=_numpy(st.batch_stats),
                       ema=_numpy(st.ema))
            if spec.get("eval"):
                out["eval"] = [float(t) for t in tr.eval_step(batch)]
    n = _build.launches(before)
    out.update(launches={"stem_train": n["stem_train"],
                         "stem_train_f32": n["stem_train_f32"]},
               ema_updates=tr.ema.updates)
    return out


def stem_rank(rank: int, world: int, group, spec: Dict) -> Dict:
    """Kernel C's differentiable stem (`fused_train_stem`) on this rank's
    slice of `spec["x"]` over the group (an even one, or `spec["sizes"][rank]`
    rows), with the cotangent `spec["gy"]` (its slice) on y.  Returns y, mean, var, the gradients of x (this rank's),
    kernel, gamma and beta (this rank's parts), and the launches; with
    `time_iters`, also the host ms of one `stem_train` over the group (the
    kernel and the sums' all-reduce), each call ending in a synchronise;
    with `sums`, also the group's sums from `stem_train` and from its plain
    twin `stem_train_plain` (after the counted launch)."""
    from dcfa_yolo_tpu_torch.ops import _build, cuda_stem_train
    from dcfa_yolo_tpu_torch.ops.cuda_stem_train import fused_train_stem

    started = time.time()
    dev = torch.device(spec.get("device", "cpu"))
    use_device(dev)
    dt = getattr(torch, spec.get("dtype", "float32"))
    if spec.get("sizes"):
        lo = sum(spec["sizes"][:rank])
        x, gy = (a[lo:lo + spec["sizes"][rank]] for a in (spec["x"], spec["gy"]))
    else:
        x, gy = shard_batch((spec["x"], spec["gy"]), rank, world)
    x = torch.from_numpy(x).to(dev, dt).requires_grad_(True)
    params = [torch.from_numpy(np.asarray(spec[k], np.float32)).to(dev).requires_grad_(True)
              for k in ("kernel", "gamma", "beta")]
    before = _build.launches()
    y, mean, var = fused_train_stem(x, *params, spec.get("eps", 1e-5), group)
    launches = _build.launches(before)["stem_train"]
    grads = torch.autograd.grad(y, [x, *params], torch.from_numpy(gy).to(dev, dt))
    host = lambda t: t.detach().float().cpu().numpy()
    out = dict(y=host(y), mean=host(mean), var=host(var), launches=launches,
               started=started,
               **{f"d_{k}": host(g) for k, g in zip(("x", "kernel", "gamma", "beta"), grads)})
    xk, w = x.detach(), params[0].detach().to(dt)
    if spec.get("sums"):
        out["sums"] = host(cuda_stem_train.stem_train(xk, w, group)[2])
        out["plain_sums"] = host(cuda_stem_train.stem_train_plain(xk, w, group)[2])
    if spec.get("time_iters"):
        out["ms"] = _host_ms(lambda: cuda_stem_train.stem_train(xk, w, group),
                             spec["time_iters"], dev)
    return out


def aug_rank(rank: int, world: int, group, spec: Dict) -> List[Dict[str, np.ndarray]]:
    """This rank's batches of `data/device_aug.py::DeviceAugLoader` over
    `spec["epochs"]` epochs: the staged arrays `spec["staged"]` (images,
    boxes, nbox, orig_wh), `input_shape`, the global `batch_size`, and
    optionally `loader` (more DeviceAugLoader arguments) and `device`.  Each
    batch as numpy arrays by Batch field."""
    from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader, StagedDataset

    ds = StagedDataset(*spec["staged"])
    ld = DeviceAugLoader(["staged"] * len(ds.images), spec["input_shape"], spec["batch_size"],
                         staged=ds, device=spec.get("device", "cpu"), rank=rank,
                         world=world, **spec.get("loader", {}))
    out = []
    for epoch in range(spec["epochs"]):
        ld.set_epoch(epoch)
        out += [{k: v.float().cpu().numpy() for k, v in b._asdict().items()} for b in ld]
    return out


def _host_ms(fn, iters: int, device: torch.device, warmup: int = 3) -> float:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return (time.perf_counter() - t0) / iters * 1e3


def allreduce_rank(rank: int, world: int, group, spec: Dict) -> Dict[str, float]:
    """Host ms of one SUM all-reduce over the group of each tensor of
    `spec["sizes"]` (name → (numel, dtype name)) on `spec["device"]`, each
    call ending in a synchronise (`spec["iters"]` calls after 3 warm-ups)."""
    import torch.distributed as dist

    dev = torch.device(spec.get("device", "cpu"))
    out = {}
    for name, (n, dtype) in spec["sizes"].items():
        t = torch.ones(n, dtype=getattr(torch, dtype), device=dev)
        out[name] = _host_ms(lambda: dist.all_reduce(t, group=group),
                             spec.get("iters", 10), dev)
    return out


def dry_batch(b: int, hw=DRY_HW, seed: int = 0):
    """A seeded host batch of b pairs with one box each, as the JAX dry
    run draws it."""
    from dcfa_yolo_tpu_torch.train.loss import pad_targets

    rng = np.random.Generator(np.random.PCG64(seed))
    rgb = rng.random((b, *hw, 3), np.float32)
    nir = rng.random((b, *hw, 3), np.float32)
    labels = np.array([[j, 0, 0.5, 0.5, 0.4, 0.4] for j in range(b)], np.float32)
    return (rgb, nir) + pad_targets(labels, b, 4, hw)


def dryrun_rank(rank: int, world: int, group, modes: Sequence[str],
                device: str) -> List[str]:
    """One rank of the dry run: a full-model step in each mode, then the
    fused check against the global batch's hand-computed moments."""
    from dcfa_yolo_tpu_torch.parallel import fused_check

    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    lines = []
    for mode in modes:
        res = train_rank(rank, world, group, dict(
            cfg=dict(num_classes=1, phi="n", input_shape=DRY_HW), seed=0,
            batch=dry_batch(2 * world), step_mode=mode, tc=dict(max_boxes=4),
            device=dev))
        loss = res["terms"][0][0]
        if not np.isfinite(loss):
            raise RuntimeError(f"rank {rank} [{mode}]: non-finite loss {loss}")
        lines.append(f"dryrun({world}) rank {rank} [{res['step_mode']}] ok: "
                     f"loss={loss:.4f}, stem {res['train_stem']}, {dev}")
    model, batch = fused_check.setup(n_batch=2 * world)
    state, loss = fused_check.run_fused(model, batch, group, rank, device=dev)
    mean, var = fused_check.global_moments(model, batch)
    n = len(batch[0])
    np.testing.assert_allclose(state["batch_stats"]["bn.running_mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state["batch_stats"]["bn.running_var"],
                               0.9 + 0.1 * var * n / (n - 1), rtol=1e-5, atol=1e-6)
    lines.append(f"dryrun({world}) rank {rank} [fused-syncbn] ok: loss={loss:.4f}, "
                 "BN moments global")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--step-mode", choices=["fused", "split"], default=None,
                    help="only this step mode (default: both)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (one a rank, NCCL) unless 'cpu' (gloo)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from dcfa_yolo_tpu_torch.device import resolve_device

        resolve_device("cuda")
        if args.n > torch.cuda.device_count():
            raise SystemExit(f"dryrun: {args.n} ranks need {args.n} cards, this host "
                             f"has {torch.cuda.device_count()}")
    modes = [args.step_mode] if args.step_mode else ["fused", "split"]
    backend = "nccl" if args.device == "cuda" else "gloo"
    for lines in run_ranks(dryrun_rank, args.n, (modes, args.device), backend=backend,
                           device=args.device):
        for line in lines:
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
