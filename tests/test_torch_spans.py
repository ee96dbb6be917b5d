"""The program's spans (`autoprog_tpu_torch/utils/spans.py`) on tiny VOLO and
DeiT models on the CPU: off (no profiler) they record nothing, create no
event and register no hook; under a profiler every span of the train step
is recorded once a step under its parent, the backward segments in reverse
order; the step's results are the same bit for bit with spans on and off;
a span's host interval is on the clock of the profiler's own events; a new
session starts with no records; and the trainer's `--profile` trace shows
the spans, the data wait among them."""

import argparse
import glob
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autoprog_tpu_torch import create_model
from autoprog_tpu_torch import main as port_main
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.train import optim as toptim
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder
from autoprog_tpu_torch.utils import spans

IMG, NC, B = 32, 10, 4
MODELS = ["volo_h2_l4", "deit_h2_l2"]
SEGMENTS = {"volo_h2_l4": ["model.stem", "model.outlookers", "model.transformers", "model.head"],
            "deit_h2_l2": ["model.stem", "model.transformers", "model.head"]}
UPDATE = ["update.fill", "update.allreduce", "update.clip", "update.optimizer", "update.ema"]


def _setup(name):
    token_label = name.startswith("volo")
    args = argparse.Namespace(
        opt="adamw", opt_eps=None, opt_betas=None, momentum=0.9, weight_decay=0.05,
        token_label=token_label, token_label_size=IMG // 16, dense_weight=0.5,
        cls_weight=1.0, ground_truth=False, smoothing=0.1, jsd=False, aug_splits=0)
    torch.manual_seed(0)
    model = create_model(name).make(num_classes=NC, img_size=IMG, dtype=torch.float32,
                                    drop_path_rate=0.1)
    decays = (0.9, 0.99)
    state = TrainState.create(model=model, optimizer=toptim.create_optimizer(args, model),
                              ema_decays=decays)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=decays, num_classes=NC,
                     token_label=token_label, has_token_label_data=token_label, seed=5)
    rs = np.random.default_rng(3)
    batch = {"image": torch.tensor(rs.normal(size=(B, IMG, IMG, 3)).astype(np.float32)),
             "label": torch.tensor(rs.integers(0, NC, B).astype(np.int32))}
    if token_label:
        batch["label_scores"] = torch.tensor(rs.random((B, 5, 2, 2)).astype(np.float32))
        batch["label_inds"] = torch.tensor(rs.integers(0, NC, (B, 5, 2, 2)).astype(np.int32))
    return sb, state, batch


def _steps(sb, state, batch, n):
    return [sb.train_step(state, batch, 1e-3, r=IMG)["loss"] for _ in range(n)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.mark.parametrize("name", MODELS)
def test_without_a_profiler_spans_record_nothing(name, monkeypatch):
    sb, state, batch = _setup(name)
    hooks = []
    real_hook = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(fn) or real_hook(self, fn))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: pytest.fail("an event"))
    _steps(sb, state, batch, 2)
    assert spans.records() == [] and spans._current is None
    assert hooks == [] and spans.span("step") is spans.span("step.loss")


@pytest.mark.parametrize("name", MODELS)
def test_under_a_profiler_every_span_is_recorded_once_a_step(name):
    sb, state, batch = _setup(name)
    _profiled(lambda: _steps(sb, state, batch, 2))
    recs = spans.records()
    segs = SEGMENTS[name]
    want = (["step", "step.input"] + segs + ["step.loss", "step.backward"] +
            [s + ".bwd" for s in reversed(segs)] + ["step.update"] + UPDATE)
    assert [r.name for r in recs] == want * 2
    parent = {"step": None, "step.backward": "step", "step.update": "step"}
    parent.update({s + ".bwd": "step.backward" for s in segs})
    parent.update({u: "step.update" for u in UPDATE})
    for i, r in enumerate(recs):
        assert r.step == i // len(want) and not r.on_card
        p = recs[r.parent].name if r.parent >= 0 else None
        assert p == parent.get(r.name, "step"), (r.name, p)
        assert r.host_ns[0] <= r.device_ns[0] <= r.device_ns[1] <= r.host_ns[1]
        if p is not None:
            outer = recs[r.parent].host_ns
            assert outer[0] <= r.host_ns[0] <= r.host_ns[1] <= outer[1]
    bwd = [r for r in recs if r.name.endswith(".bwd")]
    assert all(a.host_ns[1] <= b.host_ns[0] for a, b in zip(bwd, bwd[1:]))


@pytest.mark.parametrize("name", MODELS)
def test_the_step_is_the_same_bit_for_bit_with_spans_on(name):
    sb0, st0, batch = _setup(name)
    sb1, st1, _ = _setup(name)
    off = _steps(sb0, st0, batch, 2)
    _, on = _profiled(lambda: _steps(sb1, st1, batch, 2))
    assert len(spans.records()) > 0
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    p0, p1 = dict(st0.model.named_parameters()), dict(st1.model.named_parameters())
    for k, p in p0.items():
        assert torch.equal(p, p1[k]), k
        m0, m1 = st0.optimizer.state[p], st1.optimizer.state[p1[k]]
        assert torch.equal(m0["exp_avg"], m1["exp_avg"]), k
        assert torch.equal(m0["exp_avg_sq"], m1["exp_avg_sq"]), k
    for e0, e1 in zip(st0.ema_params, st1.ema_params):
        assert all(torch.equal(v, e1[k]) for k, v in e0.items())
    b0, b1 = dict(st0.model.named_buffers()), dict(st1.model.named_buffers())
    assert all(torch.equal(v, b1[k]) for k, v in b0.items())


def test_a_span_is_on_the_clock_of_the_profilers_events():
    x = torch.randn(64, 64)

    def run():
        with spans.span("clock"):
            return torch.mm(x, x)
    prof, _ = _profiled(run)
    (rec,) = spans.records()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(starts) == 1
    assert rec.host_ns[0] <= starts[0] <= rec.host_ns[1]


def test_a_new_session_starts_with_no_records():
    for name in ("first", None, "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            if name:
                with spans.span(name):
                    pass
        assert [(r.name, r.parent, r.step) for r in spans.records()] == \
            ([(name, -1, -1)] if name else [])


def test_the_trainers_profile_trace_shows_the_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    trace_dir = tmp_path / "trace"
    port_main.main(["synthetic://", "--model", "deit_h2_l2", "--num-classes", "8",
                    "--img-size", "32", "-b", "8", "--epochs", "1", "--warmup-epochs", "0",
                    "--cooldown-epochs", "0", "--workers", "0", "--fake-data-size", "32",
                    "--no-bf16", "--profile", str(trace_dir), "--profile-steps", "2",
                    "--output", str(tmp_path / "out")])
    names = [r.name for r in spans.records()]
    # batches 1 and 2: the wait for batch 1 came before the profiler started
    assert names.count("step") == 2 and names.count("train.to_device") == 2
    assert names.count("train.data_wait") == 1
    (path,) = glob.glob(str(trace_dir / "*.json"))
    traced = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"train.data_wait", "train.to_device", "step", "model.transformers.bwd",
            "update.ema"} <= traced
