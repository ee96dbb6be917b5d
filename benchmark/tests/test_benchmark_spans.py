"""The readers of the program's spans (`metrics/_spans.py` and the six
metrics on it): a whole `--trace 1` run on the CPU at tiny sizes reports the
segment times (not `host_lead_ms`, which needs the card) and its leaf
segments cover the `step` spans; a program without spans gives no reading
and no error; the arithmetic of the segments and of the host's lead on
records as the card gives them."""

from __future__ import annotations

import dataclasses
import sys

import pytest
import torch

from benchmark import run, spec, trace
from benchmark.metrics import _spans

SEED = 2 ** 31 + 777
SEGMENT_METRICS = {"stem_ms", "outlookers_ms", "transformers_ms", "head_loss_ms", "update_ms"}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("cell", ["volo-t", "deit-t"])
def test_a_traced_run_reports_the_segments(tiny_root, cell, capsys):
    res = run.run_rank(spec.load(cell, tiny_root), SEED, 0.3, True, device=torch.device("cpu"))
    assert res["correct"] is True, res["checks"]
    want = SEGMENT_METRICS - ({"outlookers_ms"} if cell == "deit-t" else set())
    got = res["metrics"]
    assert want <= set(got) and "host_lead_ms" not in got
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms" for m in want)
    recs = _spans.records()
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == trace.TRACE_STEPS and not recs[0].on_card
    leaves = _spans.per_step_ms(recs, _spans.LEAVES)
    assert 0.9 < leaves / _spans.per_step_ms(recs, ["step"]) <= 1.0
    assert "leaf segments cover" in capsys.readouterr().err


def test_without_the_programs_spans_the_readers_read_nothing(tiny_root, monkeypatch):
    import autoprog_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "autoprog_tpu_torch.utils.spans", None)
    res = run.run_rank(spec.load("volo-t", tiny_root), SEED, 0.3, True,
                       device=torch.device("cpu"))
    assert res["correct"] is True
    assert not (SEGMENT_METRICS | {"host_lead_ms"}) & set(res["metrics"])
    assert "step_ms_p95" in res["metrics"]


def _rec(name, parent, step, host, dev):
    from autoprog_tpu_torch.utils.spans import Record
    return Record(name, parent, step, host, dev, True)


def test_segments_and_the_hosts_lead_on_records_from_the_card(capsys):
    ms = 1_000_000
    recs = []
    for s, (lead_a, lead_b) in enumerate([(3.0, 0.5), (2.0, 4.0), (1.0, 6.0)]):
        t = 100 * s * ms
        i = len(recs)
        recs.append(_rec("step", -1, s, (t, t + 90 * ms), (t + ms, t + 91 * ms)))
        recs.append(_rec("model.stem", i, s, (t + 10 * ms, t + 11 * ms),
                         (t + 10 * ms + int(lead_a * ms), t + 20 * ms)))
        recs.append(_rec("step.backward", i, s, (t + 20 * ms, t + 40 * ms),
                         (t + 30 * ms, t + 60 * ms)))
        recs.append(_rec("model.stem.bwd", i + 2, s, (t + 21 * ms, t + 39 * ms),
                         (t + 21 * ms + int(lead_b * ms), t + 55 * ms)))
    recs.append(_rec("train.data_wait", -1, 2, (0, 1), (-10 * ms, 0)))    # outside any step
    # least leads a step: 0.5 (stem.bwd), 2.0 (stem), 1.0 (stem); median 1.0
    assert _spans.host_lead_ms(recs) == pytest.approx(1.0)
    assert "least lead at model.stem in 2 of 3 steps" in capsys.readouterr().err
    stem = _spans.per_step_ms(recs, ["model.stem", "model.stem.bwd"])
    assert stem == pytest.approx(((7 + 8 + 9) + (33.5 + 30 + 28)) / 3)
    assert _spans.host_lead_ms([dataclasses.replace(r, on_card=False) for r in recs]) is None
    assert _spans.host_lead_ms([]) is None
