"""The port's fused train stem (dcfa_yolo_tpu_torch/ops/cuda_stem_train.py)
against the JAX package's (ops/pallas_stem_train.py), run as the JAX tests
run it: `fused_train_stem(..., interpret=True)` in Pallas interpret mode and
its reference decomposition `_reference_stem`, on the CPU.  The port's
wrapper takes its plain version here (CPU tensors); the CUDA kernel is held
against the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances follow tests/test_train_stem.py: in float32 only the summation
orders differ (atol 1e-5 for y, mean and var; gradients at rtol 1e-4 of
their scale).  In bf16 the conv output is rounded before the pools and the
statistics on both sides, so y agrees to one bf16 step of its magnitude.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.models.blocks import ConvMaxpool as JaxConvMaxpool
from dcfa_yolo_tpu.ops.pallas_stem_train import (_reference_stem,
                                                 fused_train_stem as jax_fused)
from dcfa_yolo_tpu_torch.models.blocks import ConvMaxpool
from dcfa_yolo_tpu_torch.ops import _build, cuda_stem_train
from dcfa_yolo_tpu_torch.ops.cuda_stem_train import (fused_train_stem,
                                                     reference_stem,
                                                     stem_train,
                                                     stem_train_plain)

torch.set_num_threads(1)

EPS = 1e-5
SHAPE = (2, 32, 64)


def _data(seed, shape=SHAPE):
    b, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)  # HWIO
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.1).astype(np.float32)
    assert (gamma < 0).any()  # the min-pool branch is exercised
    return x, k, gamma, beta


def _port_args(x, k, gamma, beta, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(gamma), torch.from_numpy(beta))


def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def test_forward_matches_jax_f32():
    x, k, gamma, beta = _data(0)
    y_j, m_j, v_j = jax_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(gamma),
                              jnp.asarray(beta), EPS, None, True)
    y_r, m_r, v_r = _reference_stem(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(gamma), jnp.asarray(beta), EPS, None)
    y, m, v = fused_train_stem(*_port_args(x, k, gamma, beta), EPS)
    assert y.shape == (2, 16, 32, 16)
    for port, ref in ((y, y_j), (m, m_j), (v, v_j), (y, y_r), (m, m_r), (v, v_r)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("seed", [6, 7])
def test_f32_at_the_jax_suite_tolerances(seed):
    """float32, the configuration of the training CLI's float32 kernel: the
    port's fused stem (its plain version on the CPU) against JAX
    `fused_train_stem` in interpret mode at tests/test_train_stem.py's own
    tolerances (y rtol/atol 1e-5, mean atol 1e-6, var atol 1e-5)."""
    x, k, gamma, beta = _data(seed)
    y_j, m_j, v_j = jax_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(gamma),
                              jnp.asarray(beta), EPS, None, True)
    y, m, v = fused_train_stem(*_port_args(x, k, gamma, beta), EPS)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-5)


def test_plain_pools_and_sums_match_the_decomposition():
    """stem_train's outputs are what the affine needs: the max and min pools
    of ĉ and its sums, here against the JAX reference conv."""
    x, k, _, _ = _data(1)
    pmax, pmin, sums = stem_train(*_port_args(x, k, *_data(1)[2:])[:2])
    c = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (1, 1),
                                     [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    c = np.asarray(c)
    cp = np.pad(c, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=np.nan)
    win = np.stack([cp[:, dy:dy + 32:2, dx:dx + 64:2] for dy in range(3)
                    for dx in range(3)])
    np.testing.assert_allclose(pmax.numpy(), np.nanmax(win, 0), atol=1e-5)
    np.testing.assert_allclose(pmin.numpy(), np.nanmin(win, 0), atol=1e-5)
    np.testing.assert_allclose(sums[:, 0].numpy(), c.sum((0, 1, 2)), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(sums[:, 1].numpy(), (c * c).sum((0, 1, 2)),
                               rtol=1e-4)


def test_gradients_match_jax_f32():
    x, k, gamma, beta = _data(2)
    wgt = _weights((2, 16, 32, 16))

    def jloss(*a):
        y, _, _ = jax_fused(*a, EPS, None, True)
        return jnp.sum(y * wgt)

    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(gamma), jnp.asarray(beta))
    args = [t.requires_grad_(True) for t in _port_args(x, k, gamma, beta)]
    y, _, _ = fused_train_stem(*args, EPS)
    g_p = torch.autograd.grad((y * torch.from_numpy(wgt)).sum(), args)
    g_p = [g_p[0], g_p[1].permute(2, 3, 1, 0), g_p[2], g_p[3]]  # OIHW → HWIO
    for p, j in zip(g_p, g_j):
        j = np.asarray(j)
        scale = np.abs(j).max() + 1e-9
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-4, atol=1e-4 * scale)


def test_bf16_matches_jax():
    x, k, gamma, beta = _data(3)
    y_j, m_j, v_j = jax_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                              jnp.asarray(gamma), jnp.asarray(beta), EPS, None, True)
    y, m, v = fused_train_stem(*_port_args(x, k, gamma, beta, torch.bfloat16), EPS)
    assert y.dtype == torch.bfloat16
    y_j = np.asarray(y_j.astype(jnp.float32))
    d = np.abs(y.float().numpy() - y_j)
    assert (d <= 2.0 ** -7 * np.maximum(np.abs(y_j), 1.0) + 1e-6).all()
    assert (d == 0).mean() >= 0.99
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_module_matches_jax_pallas_module(backend):
    """ConvMaxpool in train mode, both graphs, against the JAX module with
    backend 'pallas': output, running update and parameter gradients."""
    x, k, gamma, beta = _data(4)
    x = (x - x.min()) / (x.max() - x.min())
    jm = JaxConvMaxpool(16, backend="pallas", stem_interpret=True)
    variables = {"params": {"conv": {"kernel": jnp.asarray(k)},
                            "bn": {"scale": jnp.asarray(gamma),
                                   "bias": jnp.asarray(beta)}},
                 "batch_stats": {"bn": {"mean": jnp.full(16, 0.1),
                                        "var": jnp.full(16, 0.9)}}}
    wgt = _weights((2, 16, 32, 16))

    def jloss(params):
        y, st = jm.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * wgt), (y, st)

    (_, (y_j, st_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    pm = ConvMaxpool(3, 16, backend=backend).train()
    with torch.no_grad():
        pm.conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        pm.bn.weight.copy_(torch.from_numpy(gamma))
        pm.bn.bias.copy_(torch.from_numpy(beta))
        pm.bn.running_mean.fill_(0.1)
        pm.bn.running_var.fill_(0.9)
    before = _build.launches()
    y = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _build.launches(before)["stem_train"] == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(pm.bn.running_mean.numpy(),
                               np.asarray(st_j["batch_stats"]["bn"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(pm.bn.running_var.numpy(),
                               np.asarray(st_j["batch_stats"]["bn"]["var"]),
                               atol=1e-6)
    (y * torch.from_numpy(wgt)).sum().backward()
    for got, ref in ((pm.conv.weight.grad.permute(2, 3, 1, 0),
                      g_j["conv"]["kernel"]),
                     (pm.bn.weight.grad, g_j["bn"]["scale"]),
                     (pm.bn.bias.grad, g_j["bn"]["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("device,cap,ok", [("cuda", (9, 0), True), ("cuda:0", (9, 0), True),
                                           ("cuda", (8, 0), False), ("cuda", (8, 9), False),
                                           ("cuda", (10, 0), False), ("cpu", (9, 0), False)])
def test_kernels_supported(monkeypatch, device, cap, ok):
    """The one predicate every `auto` resolver shares: the library holds
    sm_90a code only, so a CUDA device of capability (9, 0); require_kernels
    raises elsewhere, naming sm_90."""
    from dcfa_yolo_tpu_torch.device import kernels_supported, require_kernels

    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)
    assert kernels_supported(torch.device(device)) is ok
    assert kernels_supported(device) is ok
    if ok:
        require_kernels(device, "kernel B")
    else:
        with pytest.raises(ValueError, match="sm_90"):
            require_kernels(device, "kernel B")


def test_resolver(monkeypatch):
    cpu = torch.device("cpu")
    resolve = cuda_stem_train.resolve_train_stem
    assert resolve("auto", 16, (64, 64), torch.bfloat16, cpu) == "plain"
    assert resolve("kernel", 16, (64, 64), torch.float32, cpu) == "kernel"
    assert resolve("plain", 16, (64, 64), torch.bfloat16, cpu) == "plain"
    with pytest.raises(ValueError):
        resolve("kernel", 32, (64, 64), torch.bfloat16, cpu)
    with pytest.raises(ValueError):
        resolve("kernel", 16, (64, 63), torch.bfloat16, cpu)
    with pytest.raises(ValueError):
        resolve("pallas", 16, (64, 64), torch.bfloat16, cpu)
    # on an sm_90 card 'auto' picks kernel C in both compute dtypes
    card = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    for dtype in (torch.bfloat16, torch.float32):
        assert resolve("auto", 16, (640, 640), dtype, card) == "kernel"
        assert resolve("kernel", 16, (640, 640), dtype, card) == "kernel"
        assert resolve("auto", 16, (640, 642 - 1), dtype, card) == "plain"
    assert resolve("auto", 16, (640, 640), torch.float16, card) == "plain"
    # elsewhere it keeps the plain graph, and an explicit request raises
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    assert resolve("auto", 16, (640, 640), torch.float32, card) == "plain"
    with pytest.raises(ValueError):
        resolve("kernel", 16, (640, 640), torch.float32, card)


@pytest.mark.parametrize("backend,route", [("auto", "plain"), ("kernel", "kernel"),
                                           ("plain", "plain")])
def test_model_reports_its_train_stem_route(backend, route):
    """The model and its trainer report the stem graph the steps run; on
    the CPU 'auto' takes the plain graph."""
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64),
                                 compute_dtype="bfloat16",
                                 train_stem_backend=backend))
    assert model.train_stem_route() == route
    assert Trainer(model, TrainConfig(max_boxes=4), device="cpu").train_stem == route


def test_plain_twin_is_the_kernel_contract():
    """stem_train_plain on bf16: outputs in bf16 NHWC, ĉ rounded before the
    pools and the sums (the sums are of bf16 values)."""
    x, k, _, _ = _data(5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(torch.bfloat16)
    pmax, pmin, sums = stem_train_plain(xb, wb)
    assert pmax.dtype == pmin.dtype == torch.bfloat16
    assert pmax.shape == (2, 16, 32, 16) and sums.shape == (16, 2)
    assert (pmax >= pmin).all()
    c = torch.nn.functional.conv2d(xb.permute(0, 3, 1, 2).float(), wb.float(),
                                   padding=1).to(torch.bfloat16).float()
    torch.testing.assert_close(sums[:, 0], c.sum((0, 2, 3)), rtol=1e-5, atol=1e-3)
    y_ref, _, _ = reference_stem(xb, wb.float(), torch.ones(16), torch.zeros(16), EPS)
    assert y_ref.dtype == torch.bfloat16
