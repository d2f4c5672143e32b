"""The frozen reference against the port's plain path at a tiny size, in
float32 on the CPU: the copy is faithful at the moment it is frozen.  The
test imports both; the reference itself imports nothing of the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchlib import synth, weights
from reference import augment as ref_aug
from reference import serve as ref_serve
from reference.model import ReferenceYolo, Sizes, state_names
from reference.train import ReferenceTrainer

HW = (64, 64)


def _port_model(sizes, sd, **graph):
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.reparam import serving_state_dict
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo

    cfg = ModelConfig(phi=sizes.phi, input_shape=sizes.input_hw, compute_dtype="float32",
                      train_stem_backend="plain")
    m = DCFAYolo(cfg, **graph)
    m.load_state_dict(serving_state_dict(sd, graph.get("deploy", False),
                                         graph.get("fold_shuffle", False)), strict=True)
    return m


@pytest.mark.parametrize("phi", ["n", "s"])
def test_train_step_matches_the_port(phi):
    from dcfa_yolo_tpu_torch.config import TrainConfig
    from dcfa_yolo_tpu_torch.train.trainer import Batch, Trainer

    sizes = Sizes(phi, 1, 16, HW)
    sd = weights.make_state(state_names(sizes), 11, "training", "cpu")
    trainer = Trainer(_port_model(sizes, sd), TrainConfig(batch_size=2), device="cpu")
    rt = ReferenceTrainer(_load(ReferenceYolo(sizes), sd), "cpu")
    g = torch.Generator().manual_seed(1)
    rgb, nir = torch.rand(2, *HW, 3, generator=g), torch.rand(2, *HW, 3, generator=g)
    boxes = torch.tensor([[[5., 5., 30., 40.], [0, 0, 0, 0]],
                          [[10., 12., 50., 60.], [20, 20, 40, 40]]])
    labels, mask = torch.zeros(2, 2), torch.tensor([[1., 0], [1, 1]])
    for _ in range(2):
        lb = trainer.train_step(Batch(rgb, nir, boxes, labels, mask), 0.01)
        ref = rt.step(rgb, nir, boxes, labels, mask, 0.01)
        assert [float(t) for t in lb] == pytest.approx(ref, rel=1e-5)
    trace = trainer.optimizer.state()["trace"]
    for k, v in rt.trace.items():
        torch.testing.assert_close(trace[k], v, rtol=1e-4, atol=1e-7)
    port_sd = trainer.model.state_dict()
    for k, v in rt.model.state_dict().items():
        torch.testing.assert_close(port_sd[k], v, rtol=1e-5, atol=1e-6)
    for k, v in rt.ema.items():
        torch.testing.assert_close(trainer.ema.variables[k], v, rtol=1e-5, atol=1e-6)


def _load(model, sd):
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("graph", [{}, {"deploy": True, "fold_shuffle": True}])
def test_eval_predictions_match_the_ports_serving_graph(graph):
    from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx
    from dcfa_yolo_tpu_torch.infer.pipeline import predict

    sizes = Sizes("n", 1, 16, HW)
    sd = weights.make_state(state_names(sizes), 12, "serving", "cpu")
    port = _port_model(sizes, sd, **graph).eval()
    ref = _load(ReferenceYolo(sizes), sd)
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    nir = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    xyxy, scores, classes = predict(port, rgb, nir, stem="plain")
    boxes = correct_boxes_yxyx(xyxy, HW, torch.tensor([[48.0, 64.0]] * 2))
    p = ref_serve.predict(ref, torch.from_numpy(rgb), torch.from_numpy(nir))
    torch.testing.assert_close(p.scores, scores, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p.boxes, boxes, rtol=1e-4, atol=1e-3)
    assert torch.equal(p.classes, classes)


@pytest.mark.parametrize("shape", [(1, 48, 64), (2, 100, 80), (1, 30, 90)])
def test_letterbox_matches_the_ports(shape):
    from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch

    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (*shape, 3),
                                                             dtype=np.uint8))
    torch.testing.assert_close(ref_serve.letterbox(img, HW), letterbox_batch(img, HW),
                               rtol=0, atol=1e-3)


def test_augmentation_matches_the_ports_loader(tmp_path):
    from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader

    lines = synth.write_dataset(str(tmp_path), 8, (48, 64), 5)
    loader = DeviceAugLoader(lines, HW, 4, train=True, stage_hw=HW, seed=5,
                             epoch_length=200, device="cpu")
    ds = ref_aug.stage_pairs(lines, HW, 64)
    np.testing.assert_array_equal(ds.images, loader.host_ds.images)
    sampler = ref_aug.ParamSampler(ds, HW, epoch_length=200)
    augment = ref_aug.make_augment(HW, 64)
    ds_dev = tuple(torch.from_numpy(a) for a in (ds.images, ds.boxes, ds.nbox))
    for epoch in range(2):
        loader.set_epoch(epoch)
        for got, (_, params) in zip(loader, ref_aug.batches(ds, sampler, 4, 5, epoch)):
            want = ref_aug.run_augment(augment, ds_dev, params, "cpu")
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-5)


def test_reference_greedy_nms_keeps_a_greedy_set():
    boxes = torch.tensor([[0., 0, 10, 10], [1, 1, 11, 11], [0, 20, 10, 30], [0, 21, 10, 31]])
    scores = torch.tensor([0.9, 0.8, 0.7, 0.95])
    b, s, c = ref_serve.greedy_nms(boxes, scores, torch.zeros(4, dtype=torch.long),
                                   0.5, 0.5, 10, 10)
    assert s.tolist() == pytest.approx([0.95, 0.9])
