"""Reference weight initialization (`dcfa_yolo_tpu/train/init_weights.py`,
reference `weights_init`, `nets/yolo_training.py:480-498`) on the port's
model.

Conv kernels are drawn from normal / xavier / kaiming / orthogonal (default
normal(0, 0.02)), BatchNorm scales from N(1, 0.02), and every bias is zeroed;
BiFPN weights and the running statistics are left alone.  The draws come
from one numpy PCG64(seed) in the order the JAX package draws them: jax's
flattening order of the flax parameter tree, which is its sorted key paths,
with each kernel drawn in HWIO shape and transposed to OIHW.  The port's
initialisation is therefore bit-identical to the JAX one without JAX.

`flax_default_init` is the state `init_model(cfg, PRNGKey(seed))` gives the
JAX model before any of that, which `--model-path` and `--pretrained` load
their files over: flax's `lecun_normal` kernels, zero biases, BN γ=1, β=0
with running mean 0 and variance 1, BiFPN `w` = 1.  jax.random's stream
cannot be reproduced without JAX, so those kernels match JAX's in
distribution, not bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from dcfa_yolo_tpu_torch.ops.norm import BatchNorm


def _init_kernel(rng: np.random.Generator, shape, init_type: str,
                 init_gain: float) -> np.ndarray:
    """One HWIO kernel (`init_weights.py:20-46`)."""
    kh, kw, cin, cout = shape
    fan_in = kh * kw * cin
    fan_out = kh * kw * cout
    if init_type == "normal":
        return (rng.standard_normal(shape) * init_gain).astype(np.float32)
    if init_type == "xavier":
        std = init_gain * math.sqrt(2.0 / (fan_in + fan_out))
        return (rng.standard_normal(shape) * std).astype(np.float32)
    if init_type == "kaiming":
        std = math.sqrt(2.0 / fan_in)
        return (rng.standard_normal(shape) * std).astype(np.float32)
    if init_type == "orthogonal":
        flat = rng.standard_normal((int(np.prod(shape[:-1])), cout))
        transpose = flat.shape[0] < flat.shape[1]
        tall = flat.T if transpose else flat
        q, r = np.linalg.qr(tall)
        q = q * np.sign(np.diag(r))[None, :]
        if transpose:
            q = q.T
        return (init_gain * q.reshape(shape)).astype(np.float32)
    raise ValueError(f"unknown initialization method [{init_type}]")


def flax_param_paths(model: nn.Module) -> List[Tuple[Tuple[str, ...], str]]:
    """(flax key path, port parameter name) for every parameter, in jax's
    flattening order.  BatchNorm `weight` is flax's `scale`, any other
    `weight` a conv `kernel`."""
    out = []
    for name, _ in model.named_parameters():
        *scope, leaf = name.split(".")
        if leaf == "weight":
            mod = model.get_submodule(".".join(scope))
            leaf = "scale" if isinstance(mod, BatchNorm) else "kernel"
        out.append((tuple(scope) + (leaf,), name))
    return sorted(out)


@torch.no_grad()
def reference_weights_init(model: nn.Module, seed: int = 0,
                           init_type: str = "normal",
                           init_gain: float = 0.02) -> nn.Module:
    """Re-draw every conv kernel and BN scale in place, zero every bias."""
    rng = np.random.Generator(np.random.PCG64(seed))
    params = dict(model.named_parameters())
    for path, name in flax_param_paths(model):
        p = params[name]
        if path[-1] == "kernel" and p.dim() == 4:
            hwio = tuple(p.permute(2, 3, 1, 0).shape)
            k = _init_kernel(rng, hwio, init_type, init_gain)
            p.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        elif path[-1] == "scale" and p.dim() == 1:
            p.copy_(torch.from_numpy(
                (1.0 + rng.standard_normal(p.shape) * 0.02).astype(np.float32)))
        elif path[-1] == "bias" and p.dim() == 1:
            p.zero_()
    return model


# flax `variance_scaling`'s truncated-normal correction: the stddev of a
# unit normal truncated to ±2
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Unit normal draws truncated to [-2, 2], out-of-range values redrawn."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


@torch.no_grad()
def flax_default_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """The JAX model's initial state (`init_model`), in place: every conv
    kernel drawn as flax's `lecun_normal` (a normal truncated to ±2 with
    stddev sqrt(1 / fan_in) / 0.8796, fan_in = kh·kw·cin/groups of the
    HWIO kernel) from one numpy PCG64(seed) in jax's flattening order, each
    bias 0, BN γ=1 and β=0, running mean 0 and variance 1, BiFPN `w` 1."""
    rng = np.random.Generator(np.random.PCG64(seed))
    params = dict(model.named_parameters())
    for path, name in flax_param_paths(model):
        p = params[name]
        if path[-1] == "kernel" and p.dim() == 4:
            hwio = tuple(p.permute(2, 3, 1, 0).shape)
            std = math.sqrt(1.0 / int(np.prod(hwio[:-1]))) / _TRUNC_STD
            k = (_truncated_normal(rng, hwio) * std).astype(np.float32)
            p.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        elif path[-1] in ("scale", "w"):
            p.fill_(1.0)
        elif path[-1] == "bias":
            p.zero_()
        else:
            raise ValueError(f"no flax default for {name} ({path})")
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
