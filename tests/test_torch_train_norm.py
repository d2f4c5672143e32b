"""Train-mode BatchNorm and the max-pool gradient of the port
(dcfa_yolo_tpu_torch/ops/norm.py, ops/pool.py) against the JAX package's
`TorchExactBatchNorm` (ops/norm.py) and `max_pool_same` (ops/pool.py), on
the CPU.

BN: forward, running update and gradients (through the batch mean and
variance) in float32, for both flavours of the reference (eps 1e-3 /
momentum 0.03 and eps 1e-5 / momentum 0.1).  Only the summation orders of
the reductions differ: atol 1e-5 on outputs and statistics, gradients to
rtol 1e-4 of their scale.  Max pool: `F.max_pool2d`'s backward routes each
window's gradient to the first maximum in row-major order, as XLA's
select-and-scatter does, so on inputs full of exact ties the gradients are
equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.ops.norm import TorchExactBatchNorm
from dcfa_yolo_tpu.ops.pool import max_pool_same as jax_max_pool_same
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm
from dcfa_yolo_tpu_torch.ops.pool import max_pool_same

torch.set_num_threads(1)


@pytest.mark.parametrize("eps,momentum", [(1e-3, 0.03), (1e-5, 0.1)])
def test_train_bn_matches_jax(eps, momentum):
    rng = np.random.default_rng(int(eps * 1e5))
    x = (rng.standard_normal((3, 7, 5, 6)) * 2.0 + 0.5).astype(np.float32)  # NHWC
    scale = (1.0 + rng.standard_normal(6) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(6) * 0.2).astype(np.float32)
    mean0 = (rng.standard_normal(6) * 0.1).astype(np.float32)
    var0 = (rng.random(6) + 0.5).astype(np.float32)
    wgt = np.sin(np.arange(x.size, dtype=np.float32)).reshape(x.shape)

    jm = TorchExactBatchNorm(eps=eps, torch_momentum=momentum)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def jloss(xx, params):
        y, st = jm.apply({"params": params, "batch_stats": stats}, xx,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * wgt), (y, st["batch_stats"])

    (_, (y_j, st_j)), (gx_j, gp_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})

    bn = BatchNorm(6, eps=eps, momentum=momentum).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(wgt)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st_j["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st_j["var"]),
                               atol=1e-5)
    for got, ref in ((xt.grad.permute(0, 2, 3, 1), gx_j),
                     (bn.weight.grad, gp_j["scale"]), (bn.bias.grad, gp_j["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_eval_mode_is_the_fold():
    """eval() switches the same module back to the folded eval form."""
    bn = BatchNorm(4, eps=1e-3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_var.copy_(torch.tensor([0.5, 1.5, 1.0, 2.0]))
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    inv, shift = bn.eval().folded()
    torch.testing.assert_close(bn(x), x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1))
    before = bn.running_mean.clone()
    bn(x)
    assert torch.equal(bn.running_mean, before)  # eval leaves the statistics


def test_bn_flavours_of_the_model():
    """Momentum per BN flavour: the reference `Conv` blocks 0.03, C2fRepGhost's
    1x1 convs and every other BN (stem, ShuffleNet, RepGhost) 0.1."""
    m = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)))
    flavours = {name: (mod.eps, mod.momentum) for name, mod in m.named_modules()
                if isinstance(mod, BatchNorm)}
    assert flavours["backbone_rgb.dark2_conv.bn"] == (1e-3, 0.03)
    assert flavours["cv2_0_0.bn"] == (1e-3, 0.03)
    assert flavours["backbone_rgb.dark5_sppf.cv1.bn"] == (1e-3, 0.03)
    assert flavours["conv3_for_upsample1.cv1.bn"] == (1e-5, 0.1)
    assert flavours["conv3_for_upsample1.cv2.bn"] == (1e-5, 0.1)
    assert flavours["conv3_for_upsample1.m0.ghost1.primary_bn"] == (1e-5, 0.1)
    assert flavours["backbone_nir.stem.bn"] == (1e-5, 0.1)
    assert flavours["backbone_nir.dark3_shuffle.b2_bn2"] == (1e-5, 0.1)
    assert set(flavours.values()) == {(1e-3, 0.03), (1e-5, 0.1)}


@pytest.mark.parametrize("kernel,stride", [(3, 2), (5, 1)])
@pytest.mark.parametrize("inputs", ["zeros", "post_relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_grad_ties_match_jax(kernel, stride, inputs, dtype):
    rng = np.random.default_rng(kernel * 10 + stride)
    shape = (2, 9, 10, 3)  # NHWC
    if inputs == "zeros":
        x = np.zeros(shape, np.float32)
    else:  # ReLU output: many exact zeros, and repeated values
        x = np.maximum(np.round(rng.standard_normal(shape) * 2) / 2, 0).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out_shape = jax.eval_shape(lambda a: jax_max_pool_same(a, kernel, stride),
                               jnp.zeros(shape, jdt)).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_max_pool_same(a, kernel, stride),
                     jnp.asarray(x, jdt))
    (gx_j,) = vjp(jnp.asarray(g, jdt))

    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    y = max_pool_same(xt, kernel, stride)
    y.backward(torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        xt.grad.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(gx_j.astype(jnp.float32)))
