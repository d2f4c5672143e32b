"""The captured train step (`train/trainer.py`, `capture="auto"`).

On the CPU: which route a trainer takes, the step counts it keeps, the
flat tail's per-step values as device scalars (`train/flat_opt.py`:
`advance` writes them, `apply` reads them) against the Python-float
arithmetic they replace, and the launch registry a capture holds its
launches in (`ops/_build.py`).  On the card (marked `cuda`, skipped here):
the replayed step against the eager one from the same state, `torch.equal`
under deterministic cuDNN, with kernel C in the stem (phi n, 16 stem
channels) and without it (phi s, 32), and a captured step's launches
against an eager step's.  The file imports no JAX; on the card run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trainer_graph.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.ops import _build
from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
from dcfa_yolo_tpu_torch.train import flat_opt
from dcfa_yolo_tpu_torch.train.trainer import WARMUP_STEPS, Trainer, graph_route

HW = (64, 64)
LRS = (1e-2, 3e-3, 2.5e-2, 7e-4, 1.5e-2)      # a new learning rate every step
FREEZE = (False, True, True, False, False)    # the freeze phase toggled


def _trainer(dev, phi="n", opt="sgd", dtype="float32", **kw):
    cfg = ModelConfig(num_classes=1, phi=phi, input_shape=HW, compute_dtype=dtype)
    return Trainer(init_model(cfg, 0, dev, train=True),
                   TrainConfig(max_boxes=8, optimizer_type=opt), device=dev, **kw)


def _state(tr):
    """Every tensor of the training state, cloned, by name."""
    st = tr.state
    out = {f"p.{k}": v.clone() for k, v in st.params.items()}
    out.update({f"s.{k}": v.clone() for k, v in st.batch_stats.items()})
    out.update({f"e.{k}": v.clone() for k, v in st.ema.items()})
    for slot, v in st.opt_state.items():
        if isinstance(v, dict):
            out.update({f"o.{slot}.{k}": t.clone() for k, t in v.items()})
    return out


def _differ(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


# -- CPU --------------------------------------------------------------------
def test_route_is_chosen_from_the_device_the_group_and_the_tail():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graph_route("auto", cuda, None)
    assert not graph_route("off", cuda, None)
    assert not graph_route("auto", cpu, None)
    assert not graph_route("auto", cuda, object())
    with pytest.raises(ValueError):
        _trainer("cpu", capture="always")


def test_cpu_steps_run_eagerly_and_are_counted():
    tr = _trainer("cpu")
    assert not tr.graph_route
    b = tr.put_batch(*synthetic_batch(2, HW, 8, 1))
    for _ in range(WARMUP_STEPS + 2):
        lb = tr.train_step(b, 1e-2)
    assert tr.graph_stats() == {"captures": 0, "replays": 0, "eager": WARMUP_STEPS + 2}
    assert tr._graph is None and np.isfinite(float(lb.total))
    lb, g = tr.step_with_grad(b, 1e-2)
    assert tr.graph_stats()["eager"] == WARMUP_STEPS + 3
    assert g.shape == (tr._p_layout.n,) and g.dtype == torch.float32


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_device_scalars_equal_the_python_float_tail(opt):
    """`FlatOptimizer` and `FlatEMA` (scalars written by `advance`) against
    `flat_update` and `flat_ema` with Python floats, on flat vectors over
    5 steps with the learning rate changed every step and the freeze
    phase toggled: bit for bit."""
    rng = np.random.default_rng(5)
    named = [("backbone_rgb.c1.weight", torch.from_numpy(
                 rng.standard_normal((8, 4, 3, 3)).astype(np.float32))),
             ("neck.bi_fpn.w", torch.from_numpy(rng.standard_normal(3).astype(np.float32))),
             ("neck.c2.weight", torch.from_numpy(
                 rng.standard_normal((4, 8, 1, 1)).astype(np.float32))),
             ("head.bn.bias", torch.from_numpy(rng.standard_normal(8).astype(np.float32)))]
    tc = TrainConfig(optimizer_type=opt)
    layout = flat_opt.FlatLayout(named)
    p_ref = layout.ravel([t for _, t in named])
    opt_ref = flat_opt.init_flat_opt(tc, layout.n)
    factors = flat_opt.build_factors(named, train_bifpn=False)
    p = p_ref.clone()
    dev_opt = flat_opt.FlatOptimizer(tc, named, p, train_bifpn=False)
    stats = [("bn.running_mean", torch.zeros(5))]
    ema_ref = (p_ref.clone(), torch.zeros(5))
    ema = flat_opt.FlatEMA(layout.names, (layout, p), (flat_opt.FlatLayout(stats),
                                                       torch.zeros(5)), updates=3)
    for step, (lr, freeze) in enumerate(zip(LRS, FREEZE)):
        g = torch.from_numpy((rng.standard_normal(layout.n) * 10).astype(np.float32))
        upd, opt_ref = flat_opt.flat_update(tc, factors, g, p_ref, opt_ref, freeze)
        p_ref.add_(upd.mul_(lr))
        flat_opt.flat_ema(ema_ref[0], p_ref, 3 + step + 1, tc.ema_decay, tc.ema_tau)
        dev_opt.advance(lr)
        dev_opt.apply(g, freeze)
        ema.advance(tc.ema_decay, tc.ema_tau)
        ema.apply()
        assert float(dev_opt.lr) == float(np.float32(lr))
        assert torch.equal(p, p_ref), step
        assert torch.equal(ema.vecs[0], ema_ref[0]), step
    assert ema.updates == 3 + len(LRS)
    if opt == "adam":
        assert dev_opt.count == opt_ref.count == len(LRS)
        assert torch.equal(dev_opt.opt.mu, opt_ref.mu) and torch.equal(dev_opt.opt.nu, opt_ref.nu)
    else:
        assert torch.equal(dev_opt.opt.trace, opt_ref.trace)


def test_a_hold_hands_back_its_launches_and_adding_them_restores_the_total():
    """Launches counted inside `held_launches` are taken out of the counts
    and handed back by name; adding them (a replay) counts them again."""
    start = _build.launches()
    _build.check(0, "outside", "stem_eval")
    with _build.held_launches() as held:
        _build.check(0, "captured", "stem_train", "stem_train_f32")
        _build.check(0, "captured", "bn_train")
        _build.check(0, "captured", "bn_train")
        assert _build.launches(start) == {"stem_eval": 1, "stem_train": 1,
                                          "stem_train_f32": 1, "bn_train": 2}
    assert held == {"stem_train": 1, "stem_train_f32": 1, "bn_train": 2}
    assert _build.launches(start) == {"stem_eval": 1}
    for replays in (1, 2):
        _build.add_launches(held)
        assert _build.launches(start) == {"stem_eval": 1, "stem_train": replays,
                                          "stem_train_f32": replays, "bn_train": 2 * replays}
    assert _build.launches(start)["nms_suppress"] == 0  # a name never counted reads 0


def test_a_failed_launch_counts_nothing_and_a_failed_capture_restores_the_counts():
    start = _build.launches()
    with pytest.raises(RuntimeError, match="captured"):
        with _build.held_launches() as held:
            _build.check(0, "captured", "bn_train")
            raise RuntimeError("captured step failed")
    assert held == {"bn_train": 1} and not _build.launches(start)
    lib = _build._LIB
    _build._LIB = type("Lib", (), {"dcfa_error_string": staticmethod(lambda rc: b"boom")})
    try:
        with pytest.raises(RuntimeError, match="CUDA error 7"):
            _build.check(7, "stem_eval", "stem_eval")
    finally:
        _build._LIB = lib
    assert not _build.launches(start)


# -- the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def _batches(tr, n, seed=20):
    return [tr.put_batch(*synthetic_batch(2, HW, 8, seed + i)) for i in range(n)]


def _run(tr, batches, lrs, freezes):
    """Steps on copies of the batches (a captured trainer takes the capturing
    call's batch as its input): the loss terms of each step, stacked."""
    return [torch.stack(list(tr.train_step(type(b)(*(t.clone() for t in b)), lr,
                                           freeze_backbone=fr)))
            for b, lr, fr in zip(batches, lrs, freezes)]


@pytest.mark.cuda
@pytest.mark.parametrize("phi,dtype,launches", [("n", "bfloat16", 2), ("n", "float32", 2),
                                                ("s", "bfloat16", 0)])
def test_replayed_steps_equal_eager_steps(cuda, phi, dtype, launches):
    eager = _trainer(cuda, phi, dtype=dtype, capture="off")
    graph = _trainer(cuda, phi, dtype=dtype)
    assert graph.graph_route and not eager.graph_route
    assert graph.train_stem == ("kernel" if launches else "plain")
    batches = _batches(graph, len(LRS))
    want = _run(eager, batches, LRS, [False] * len(LRS))
    torch.cuda.synchronize()
    before = _build.launches()
    got = _run(graph, batches, LRS, [False] * len(LRS))
    torch.cuda.synchronize()
    assert _build.launches(before)["stem_train"] == launches * len(LRS)
    assert graph.graph_stats() == {"captures": 1, "replays": len(LRS) - WARMUP_STEPS,
                                   "eager": WARMUP_STEPS}
    for step, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), step
    assert not _differ(_state(graph), _state(eager))
    assert graph.ema.updates == eager.ema.updates == len(LRS)


@pytest.mark.cuda
@pytest.mark.parametrize("phi,dtype", [("n", "bfloat16"), ("n", "float32"), ("s", "bfloat16")])
def test_a_captured_step_holds_what_an_eager_step_launches(cuda, phi, dtype):
    """The launches a capture holds equal an eager step's, name by name
    (kernel C in both dtypes at phi n, kernel D at every phi); the capture
    itself counts nothing, and each replay adds them."""
    tr = _trainer(cuda, phi, dtype=dtype)
    b = _batches(tr, 1)[0]
    for _ in range(WARMUP_STEPS - 1):
        tr.train_step(b, 1e-2)
    before = _build.launches()
    tr.train_step(b, 1e-2)  # the last eager step of the warm-up
    eager = _build.launches(before)
    assert eager["bn_train"] > 0 and eager["bn_train"] % 6 == 0
    assert eager["stem_train"] == (2 if phi == "n" else 0)
    assert eager["stem_train_f32"] == (2 if (phi, dtype) == ("n", "float32") else 0)
    before = _build.launches()
    tr.train_step(b, 1e-2)  # the capture, then its first replay
    assert tr.graph_stats() == {"captures": 1, "replays": 1, "eager": WARMUP_STEPS}
    assert dict(tr._graph.launches) == dict(eager)
    assert _build.launches(before) == eager
    for _ in range(2):
        tr.train_step(b, 1e-2)
    assert _build.launches(before) == {k: 3 * n for k, n in eager.items()}


@pytest.mark.cuda
def test_a_returned_loss_outlives_later_replays(cuda):
    tr = _trainer(cuda)
    batches = _batches(tr, 5)
    held = [tr.train_step(b, 1e-2) for b in batches]
    kept = [torch.stack(list(lb)).cpu() for lb in held]
    for b in batches:
        tr.train_step(b, 1e-2)
    assert tr.graph_stats()["replays"] == len(batches) * 2 - WARMUP_STEPS
    assert all(torch.equal(torch.stack(list(lb)).cpu(), k) for lb, k in zip(held, kept))
    assert not torch.equal(kept[-1], kept[-2])
    lb, g = tr.step_with_grad(batches[0], 1e-2)
    g2 = tr.step_with_grad(batches[1], 1e-2)[1]
    assert g.data_ptr() != g2.data_ptr() and not torch.equal(g, g2)


@pytest.mark.cuda
def test_a_learning_rate_change_between_replays_takes_effect(cuda):
    tr = _trainer(cuda)
    b = _batches(tr, 1)[0]
    for _ in range(WARMUP_STEPS + 1):
        tr.train_step(b, 1e-2)
    assert tr.graph_stats()["replays"] == 1
    before = tr.flat_params.clone()
    tr.train_step(b, 0.0)
    assert torch.equal(tr.flat_params, before)  # lr 0: no parameter moves
    tr.train_step(b, 1e-2)
    assert not torch.equal(tr.flat_params, before)
    assert tr.graph_stats() == {"captures": 1, "replays": 3, "eager": WARMUP_STEPS}


@pytest.mark.cuda
def test_a_freeze_toggle_recaptures_and_releases_the_old_graph(cuda):
    eager, graph = _trainer(cuda, capture="off"), _trainer(cuda)
    freezes = [True] * 3 + [False] * 4
    lrs = [1e-2] * len(freezes)
    batches = _batches(graph, len(freezes), seed=40)
    want = _run(eager, batches, lrs, freezes)
    got = []
    for b, lr, fr in zip(batches, lrs, freezes):
        got.append(torch.stack(list(graph.train_step(b, lr, freeze_backbone=fr))))
        if len(got) == 4:  # the first step unfrozen: the frozen graph is gone
            assert graph._graph is None and graph.graph_stats()["captures"] == 1
    assert graph._graph.key[1] is False
    # frozen: 2 eager, a capture and its replay; unfrozen: 2 eager, a capture
    # and its replay, a replay
    assert graph.graph_stats() == {"captures": 2, "replays": 3, "eager": 4}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not _differ(_state(graph), _state(eager))


@pytest.mark.cuda
def test_a_restored_state_then_a_replay_equals_eager(cuda):
    graph = _trainer(cuda)
    batches = _batches(graph, 6, seed=60)
    _run(graph, batches[:4], [1e-2] * 4, [False] * 4)
    saved = graph.state
    saved = type(saved)({k: v.clone() for k, v in saved.params.items()},
                        {k: v.clone() for k, v in saved.batch_stats.items()},
                        {"trace": {k: v.clone() for k, v in saved.opt_state["trace"].items()}},
                        {k: v.clone() for k, v in saved.ema.items()}, saved.ema_updates)
    _run(graph, batches[4:], [1e-2] * 2, [False] * 2)
    graph.state = saved
    eager = _trainer(cuda, capture="off")
    eager.state = saved
    got = _run(graph, batches[4:], [3e-3] * 2, [False] * 2)
    want = _run(eager, batches[4:], [3e-3] * 2, [False] * 2)
    assert graph.graph_stats()["replays"] == 6
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not _differ(_state(graph), _state(eager))
