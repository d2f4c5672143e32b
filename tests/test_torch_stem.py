"""Port stem (dcfa_yolo_tpu_torch/ops/cuda_stem.py) vs the JAX package's
Pallas stems (ops/pallas_stem.py), run as the JAX tests run them: in Pallas
interpret mode on the CPU.  The port's wrapper takes its plain version here
(CPU tensors); the CUDA kernel is held against the same plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances are the v4 class of tests/test_pallas_stem.py:127-159: the
products are exact in f32 (0..255 integers times bf16 weights) and the sums
short (27 terms + bias), so only the f32 summation order differs — atol 0.03
/ rtol 0.02 and at least 99.9% bit-equal bf16 outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfa_yolo_tpu.ops.pallas_stem import (fold_stem_params,
                                           fold_stem_params_e, pallas_stem,
                                           pallas_stem_e)
from dcfa_yolo_tpu.ops.resize import deinterleave_cols_cf
from dcfa_yolo_tpu_torch.ops import cuda_stem

torch.set_num_threads(1)


def _inputs(seed, shape):
    b, h, w = shape
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 16)) * 0.3).astype(np.float32)  # HWIO
    gamma = (rng.standard_normal(16) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(16) * 0.2).astype(np.float32)
    mean = (rng.standard_normal(16) * 0.1).astype(np.float32)
    var = (rng.random(16) + 0.5).astype(np.float32)
    return img, (k, gamma, beta, mean, var)


def _port_fold(params):
    k, gamma, beta, mean, var = (torch.from_numpy(p) for p in params)
    return cuda_stem.fold_stem_params(k.permute(3, 2, 0, 1), gamma, beta,
                                      mean, var)


def _canvas(img):
    return np.pad(img.transpose(0, 3, 1, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_bit_equal_to_fold_stem_params_e(seed):
    """Folded weights and bias equal the v4 matrix read at its documented
    layout: we[(dx·3+ci)·24 + dy, co] and we[18, co]."""
    _, params = _inputs(seed, (1, 2, 2))
    we = np.asarray(fold_stem_params_e(*(jnp.asarray(p) for p in params)),
                    np.float32)
    w, bias = _port_fold(params)
    assert w.dtype == torch.bfloat16 and bias.dtype == torch.float32
    w = w.float().numpy()
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                np.testing.assert_array_equal(
                    we[(dx * 3 + ci) * 24 + dy, :16], w[:, ci, dy, dx])
    np.testing.assert_array_equal(we[18, :16], bias.numpy())


def _check_v4_class(port, ref):
    np.testing.assert_allclose(port, ref, atol=0.03, rtol=0.02)
    frac = (port == ref).mean()
    assert frac >= 0.999, f"only {frac} bit-equal"


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 130)])
def test_stem_plain_matches_pallas_e(shape):
    img, params = _inputs(11, shape)
    x_cf = _canvas(img)
    we = fold_stem_params_e(*(jnp.asarray(p) for p in params))
    ref = pallas_stem_e(deinterleave_cols_cf(jnp.asarray(x_cf)), we,
                        w=shape[2], interpret=True)
    ref = np.asarray(jnp.transpose(ref, (0, 1, 3, 2)), np.float32)  # NHWC

    w, bias = _port_fold(params)
    before = cuda_stem.LAUNCHES
    out = cuda_stem.stem_eval(torch.from_numpy(x_cf).to(torch.bfloat16), w, bias)
    assert cuda_stem.LAUNCHES == before  # CPU tensors never launch the kernel
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2, 16)
    assert out.dtype == torch.bfloat16
    _check_v4_class(out.float().numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 130)])
def test_stem_plain_matches_pallas_v2(shape):
    """Against v2, whose bias stays unrounded f32: tolerance-level against it
    as is, and v4-class bit agreement once its bias is bf16-rounded like the
    port's (the same comparison as test_pallas_stem_v4_matches_v3)."""
    img, params = _inputs(12, shape)
    x_np = _canvas(img)
    x_cf = jnp.asarray(x_np)
    wd, bias2 = fold_stem_params(*(jnp.asarray(p) for p in params))
    w, bias = _port_fold(params)
    out = cuda_stem.stem_eval(torch.from_numpy(x_np).to(torch.bfloat16),
                              w, bias).float().numpy()
    for b2, exact in ((bias2, False),
                      (bias2.astype(jnp.bfloat16).astype(jnp.float32), True)):
        ref = pallas_stem(x_cf, wd, b2, interpret=True)
        ref = np.asarray(jnp.transpose(ref, (0, 1, 3, 2)), np.float32)
        if exact:
            _check_v4_class(out, ref)
        else:
            np.testing.assert_allclose(out, ref, atol=0.03, rtol=0.02)


def test_stem_eval_rejects_bad_shapes():
    w = torch.zeros((16, 3, 3, 3), dtype=torch.bfloat16)
    b = torch.zeros(16)
    with pytest.raises(ValueError):
        cuda_stem.stem_eval(torch.zeros((1, 3, 9, 10), dtype=torch.bfloat16), w, b)
    with pytest.raises(ValueError):
        cuda_stem.stem_eval(torch.zeros((1, 4, 10, 10), dtype=torch.bfloat16), w, b)
    with pytest.raises(ValueError):
        cuda_stem.stem_eval(torch.zeros((1, 3, 10, 10), dtype=torch.bfloat16),
                            w[:8], b)
