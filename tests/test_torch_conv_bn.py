"""A conv feeding a train-mode BatchNorm in bfloat16 (`ops/conv.py::conv_bn`)
against the JAX package's compiled conv + BN.

The JAX BN casts its input to float32 at once
(`dcfa_yolo_tpu/ops/norm.py:60,84`) and XLA folds the cast into the
convolution: the BN reads the conv's float32 sums, never their bf16
rounding.  The port hands a train-mode BN the same
float32 sums (`Conv.accumulate`), so the BN output equals the jitted JAX
module's up to the float32 summation order: at least 99.9% of the values
bit-equal, the rest one bf16 step apart (rounding the sums first leaves
about 73% bit-equal).  So for the 3x3 convs of the backbones, the neck and
the head, the stride-2 ones, the 1x1 convs and the RepGhost depthwise conv.
A biased conv, float32 and eval mode keep `bn(conv(x))`; so does the stem,
which keeps the Pallas stem's contract (`tests/test_torch_train_stem.py`).

The backward of those float32 sums (`_Accumulate`) against the VJP of the
jitted JAX conv followed by its float32 cast, which rounds the cotangent to
bf16 before the conv's transpose: the input gradient ≥ 99.9% bit-equal
and the rest within one bf16 step of its largest entry, the weight gradient equal to JAX's rounded once to bf16
(the jaxpr's rounding; the CPU compile leaves those sums in float32).
Without the cotangent's rounding about 58% of either gradient is bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.ops.conv import ConvBnAct as JaxConvBnAct
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.ops.conv import Conv, ConvBnAct, conv_bn
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm

torch.set_num_threads(1)


def _inputs(c, seed):
    x = np.random.default_rng(seed).standard_normal((2, 16, 16, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, xt.permute(0, 3, 1, 2)


def _assert_equal_up_to_order(y, y_jax, step=None):
    """≥ 99.9% bit-equal, the rest within one bf16 step of the JAX value
    (or of `step`)."""
    same = float((y == y_jax).mean())
    if step is None:
        step = np.spacing(np.abs(y_jax).astype(jnp.bfloat16)).astype(np.float32)
    assert same >= 0.999, same
    assert (np.abs(y - y_jax) <= step).all(), float(np.abs(y - y_jax).max())


def _jax_train(module, variables, xj):
    out, _ = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, xj)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("k,s,depthwise", [(3, 1, False), (3, 2, False), (1, 1, False),
                                           (3, 1, True)])
def test_train_bn_reads_the_conv_sums_as_the_compiled_jax_step(k, s, depthwise):
    c = 16
    xj, xt = _inputs(c, k * 10 + s + depthwise)
    jm = JaxConvBnAct(c, k, s, groups=c if depthwise else 1, act="none", dtype=jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(k + s), xj, train=False)
    variables["params"] = jax.tree_util.tree_map(  # BN affine away from (1, 0)
        lambda v: v * 1.3 + 0.1, variables["params"])
    y_jax = _jax_train(jm, variables, xj)

    pm = ConvBnAct(c, c, k, s)
    if depthwise:
        pm.conv = Conv(c, c, k, s, g=c)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    pm.train()
    with torch.no_grad():
        y = conv_bn(pm.conv, pm.bn, xt).permute(0, 2, 3, 1).float().numpy()
    _assert_equal_up_to_order(y, y_jax)


@pytest.mark.parametrize("k,s,depthwise", [(3, 1, False), (3, 2, False), (1, 1, False),
                                           (3, 1, True)])
def test_conv_sums_backward_rounds_the_cotangent_as_the_jax_cast(k, s, depthwise):
    c, g = 16, 16 if depthwise else 1
    rng = np.random.default_rng(k * 10 + s + depthwise)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, c)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, k, c // g, c)) * 0.2, jnp.float32)
    ho = (16 - 1) // s + 1
    cot = jnp.asarray(rng.standard_normal((2, ho, ho, c)), jnp.float32)

    def sums(x, w):
        return jax.lax.conv_general_dilated(
            x, w.astype(jnp.bfloat16), (s, s), [(k // 2, k // 2)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=g).astype(jnp.float32)
    gx, gw = jax.jit(lambda x, w: jax.vjp(sums, x, w)[1](cot))(x, w)
    gw = np.asarray(gw.astype(jnp.bfloat16).astype(jnp.float32))

    conv = Conv(c, c, k, s, g=g)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy()))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(0, 3, 1, 2)
    xt = xt.to(torch.bfloat16).requires_grad_(True)
    conv.accumulate(xt).backward(torch.from_numpy(np.asarray(cot)).permute(0, 3, 1, 2))
    gx = np.asarray(gx.astype(jnp.float32))
    _assert_equal_up_to_order(xt.grad.float().permute(0, 2, 3, 1).numpy(), gx,
                              np.spacing(np.abs(gx).max().astype(jnp.bfloat16)))
    _assert_equal_up_to_order(conv.weight.grad.permute(2, 3, 1, 0).numpy(), gw)


@pytest.mark.parametrize("case", ["float32", "eval", "biased"])
def test_other_cases_keep_bn_of_the_rounded_conv(case):
    torch.manual_seed(0)
    conv = Conv(8, 8, 3, g=8, bias=True) if case == "biased" else Conv(8, 8, 3)
    bn = BatchNorm(8)
    bn.train(case != "eval")
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x = torch.randn(2, 8, 10, 10).to(dtype)
    with torch.no_grad():
        assert torch.equal(conv_bn(conv, bn, x), bn(conv(x)))
