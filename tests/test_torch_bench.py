"""The port's measurement path on the CPU: `detect_batch` on the deploy +
folded graph against the JAX package's, the bench's JSON line, the summary's
counts, and the deploy predictor against the train-graph predictor."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.infer.pipeline import detect_batch as jax_detect_batch
from dcfa_yolo_tpu.models.reparam import deploy_variables, fold_shuffle_variables
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.models.yolo import count_params as jax_count_params
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch import bench, summary
from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _pairs(seed, b, hw):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8))


def _assert_detections_agree(ref, out):
    """tests/test_torch_pipeline.py's float32 criterion: classes, valid and
    n_candidates equal, boxes within 1e-3 px, scores within 1e-5."""
    np.testing.assert_array_equal(out.n_candidates.numpy(), np.asarray(ref.n_candidates))
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes), atol=1e-3)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), atol=1e-5)


def test_detect_batch_deploy_folded_matches_jax(manifest):
    """The slice end to end, float32 at 64² on letterboxed 48×72 pairs: the
    port's deploy + folded graph against JAX `detect_batch` with
    DCFAYolo(deploy=True, fold_shuffle=True), both on the JAX-transformed
    reference synthetic weights."""
    hw = (64, 64)
    model = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n"))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    variables = fold_shuffle_variables(deploy_variables(variables))
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=hw),
                         deploy=True, fold_shuffle=True)
    rgb, nir = _pairs(5, 2, (48, 72))
    image_hw = np.tile([48.0, 72.0], (2, 1)).astype(np.float32)
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=50, pre_nms_topk=128)
    ref = jax.jit(lambda r, n, h: jax_detect_batch(
        jmodel, variables, r, n, h, stem_backend="xla", nms_backend="xla", **kw))(
        jnp.asarray(rgb), jnp.asarray(nir), jnp.asarray(image_hw))
    pred = YOLOPredictor(["obj"], input_shape=hw, variables=variables, deploy=True,
                         fold_shuffle=True, device="cpu")
    out = detect_batch(pred.model, rgb, nir, image_hw, **kw)
    assert out.valid.any()
    _assert_detections_agree(ref, out)


def _root_bench_keys():
    """The key set of the JSON line the root bench.py prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


def test_bench_cpu_json_line(monkeypatch, capsys):
    for k, v in dict(BENCH_DEVICE="cpu", BENCH_SIZE="64", BENCH_BATCH="2",
                     BENCH_ITERS="1").items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == _root_bench_keys() | {"notes", "pipeline", "eager_value",
                                             "eager_b1_ms_pair"}
    assert rec["pipeline"] == "eager" and rec["eager_value"] is None
    assert rec["hbm_gbps"] is None and rec["hbm_util"] is None
    assert "bytes accessed" in rec["notes"]
    assert rec["device"] == "cpu" and rec["mfu"] is None and rec["tflops"] is None
    assert rec["value"] > 0 and rec["b1_ms_pair"] > 0
    assert rec["stem_backend"] in ("plain", "kernel")
    assert set(rec["stem_autotune"]) == {"plain", "kernel"}
    assert rec["gflop_per_pair"] > 0


@pytest.mark.parametrize("cap,kernel", [((9, 0), True), ((8, 0), False), ((9, 1), False)])
def test_bench_stem_candidates_need_sm90(monkeypatch, cap, kernel):
    """The stem autotune times kernel A only where it runs: an sm_90 card
    (or the CPU, where its wrapper takes the plain version), and only for a
    model it fits."""
    from dcfa_yolo_tpu_torch.config import ModelConfig

    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)
    cfg = ModelConfig(num_classes=1, phi="n", compute_dtype="bfloat16")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert bench.stem_candidates(cfg, card) == ["plain"] + ["kernel"] * kernel
    assert bench.stem_candidates(cfg, cpu) == ["plain", "kernel"]
    f32 = ModelConfig(num_classes=1, phi="n", compute_dtype="float32")
    assert bench.stem_candidates(f32, card) == ["plain"]


def test_bench_knobs_reach_the_pipeline(monkeypatch, capsys):
    """BENCH_IN_DTYPE, BENCH_CAST_W, BENCH_FOLD_SHUFFLE, BENCH_NMS, BENCH_STEM
    and BENCH_B1 set away from their defaults, each seen where the bench
    calls the pipeline."""
    import dcfa_yolo_tpu_torch.infer.pipeline as pipeline

    seen = []
    orig = pipeline.detect_batch

    def spy(model, rgb, nir, image_hw, **kw):
        seen.append(dict(
            fold_shuffle=model.fold_shuffle, deploy=model.deploy, in_dtype=rgb.dtype,
            w_dtype=model.backbone_rgb.dark3_conv.conv.weight.dtype,
            nms=kw["nms"], stem=kw["stem"], batch=rgb.shape[0]))
        return orig(model, rgb, nir, image_hw, **kw)

    monkeypatch.setattr(pipeline, "detect_batch", spy)
    for k, v in dict(BENCH_DEVICE="cpu", BENCH_SIZE="64", BENCH_BATCH="2",
                     BENCH_ITERS="1", BENCH_IN_DTYPE="f32", BENCH_CAST_W="1",
                     BENCH_FOLD_SHUFFLE="0", BENCH_NMS="plain", BENCH_STEM="plain",
                     BENCH_B1="0").items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["stem_backend"] == "plain" and rec["stem_autotune"] is None
    assert rec["b1_ms_pair"] is None and rec["value"] > 0
    assert seen and all(c == dict(fold_shuffle=False, deploy=True,
                                  in_dtype=torch.float32, w_dtype=torch.bfloat16,
                                  nms="plain", stem="plain", batch=2) for c in seen)


def test_bench_explicit_kernel_stem_that_cannot_be_met_raises(monkeypatch):
    """BENCH_STEM=kernel needs an even input shape: 63² cannot take it."""
    for k, v in dict(BENCH_DEVICE="cpu", BENCH_SIZE="63", BENCH_BATCH="1",
                     BENCH_ITERS="1", BENCH_STEM="kernel").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="even input shape"):
        bench.run()


def _independent_flops(model, hw):
    """2·Cout·(Cin/g)·k²·Ho·Wo for every nn.Conv2d (forward hooks), plus the
    two products of each align-corners resize of the neck."""
    import dcfa_yolo_tpu_torch.models.yolo as yolo_mod

    total = [0]

    def conv_hook(mod, _inp, out):
        kh, kw = mod.kernel_size
        total[0] += (2 * out.shape[0] * mod.out_channels * (mod.in_channels // mod.groups)
                     * kh * kw * out.shape[2] * out.shape[3])

    resize = yolo_mod.resize_bilinear_align_corners

    def counted_resize(x, out_hw):
        b, c, h, w = x.shape
        total[0] += 2 * b * c * out_hw[0] * h * w + 2 * b * c * out_hw[0] * w * out_hw[1]
        return resize(x, out_hw)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        yolo_mod.resize_bilinear_align_corners = counted_resize
        x = torch.zeros(1, *hw, 3)
        with torch.inference_mode():
            model(x, x)
    finally:
        yolo_mod.resize_bilinear_align_corners = resize
        for h in hooks:
            h.remove()
    return total[0]


def test_summary_counts(capsys):
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model

    assert summary.main(["--device", "cpu", "--input-shape", "64", "64"]) == 0
    text = capsys.readouterr().out
    params = int(re.search(r"Total params: ([\d,]+)", text).group(1).replace(",", ""))
    gflops = re.search(r"Total GFLOPs: ([\d.]+)G", text).group(1)
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n"))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    assert params == jax_count_params(template) == 2_678_850
    model = init_model(ModelConfig(num_classes=1, input_shape=(64, 64)), 0, "cpu")
    assert gflops == f"{_independent_flops(model, (64, 64)) / 1e9:.3f}"
    assert "backbone_rgb" in text and "conv3_for_downsample2" in text


def test_deploy_predictor_matches_train_predictor():
    """YOLOPredictor on the deploy + folded graph against the train-graph
    predictor from the same init_model weights, float32 at 64²
    (cast_weights does nothing in float32, as in the JAX package)."""
    kw = dict(input_shape=(64, 64), confidence=0.3, nms_iou=0.5, max_det=50,
              pre_nms_topk=128, device="cpu")
    base = YOLOPredictor(["obj"], **kw)
    dep = YOLOPredictor(["obj"], deploy=True, fold_shuffle=True, cast_weights=True, **kw)
    assert dep.model.backbone_rgb.dark3_conv.conv.weight.dtype == torch.float32
    rgb, nir = _pairs(9, 2, (48, 72))
    ref, out = base._run(rgb, nir, None), dep._run(rgb, nir, None)
    assert ref.valid.any()
    np.testing.assert_array_equal(out.classes, ref.classes)
    np.testing.assert_array_equal(out.valid, ref.valid)
    np.testing.assert_allclose(out.boxes, ref.boxes, atol=1e-3)
    np.testing.assert_allclose(out.scores, ref.scores, atol=1e-5)
    assert dep.get_fps(rgb[0], nir[0], test_interval=2) > 0
    assert dep.cap_stats["images"] == 2 + 3
