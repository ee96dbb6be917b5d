"""`autoprog_tpu_torch.bench`, the port of the repo's headline `bench.py`, on
the CPU: the output contract (exactly one JSON line on stdout with the four
keys of the JAX script, per-stage lines on stderr), the state and target
knobs and the device policy. Times taken here say nothing about the card; chip_smoke.py
runs the same `main()` there.
"""

import json
import os

import pytest
import torch

from autoprog_tpu_torch import bench
from autoprog_tpu_torch.train.optim import AdamWBf16Mu

KNOBS = ("AUTOPROG_BENCH_EMA_BF16", "AUTOPROG_BENCH_MU_BF16", "AUTOPROG_SPARSE_TL")


def test_main_prints_one_json_line_with_the_four_keys(monkeypatch, capsys):
    """CPU-sized run (batch 8, one timed step per configuration) of the full
    volo_d1 recipe and the four stage configs."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    for env in KNOBS:
        monkeypatch.delenv(env, raising=False)
    result = bench.main()
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    assert list(result) == ["metric", "value", "unit", "vs_baseline"]
    assert result["metric"] == "volo_d1_train_imgs_per_sec_per_chip"
    assert result["unit"] == "img/s"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    stages = [ln for ln in cap.err.splitlines() if ln.startswith("# stage r=")]
    assert [ln.split(":")[0] for ln in stages] == [
        "# stage r=128 l=9", "# stage r=160 l=12", "# stage r=192 l=15", "# stage r=224 l=18"]
    assert "# full-size step:" in cap.err


def test_metric_and_stage_configs_are_the_jax_script_s():
    import re
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "bench.py")) as f:
        src = f.read()
    assert f'"{bench.METRIC}"' in src
    cfgs = re.search(r"stage_cfgs = \[(.*?)\]", src).group(1)
    assert tuple(eval(f"[{cfgs}]")) == bench.STAGE_CFGS
    assert 'create_model("volo_h12_l18")' in src and bench.MODEL == "volo_h12_l18"
    assert "(0.998, 0.9986, 0.999, 0.9996)" in src
    assert bench.EMA_DECAYS == (0.998, 0.9986, 0.999, 0.9996)


@pytest.mark.parametrize("env", KNOBS)
def test_each_knob_sets_what_it_names(monkeypatch, env):
    """Each knob set to 1 changes its own piece of the benched step (bf16
    EMA trees, a bf16 Adam first moment, sparse token-label targets) and
    nothing else; set to 0 it changes nothing. The recipe is shrunk to
    volo_h2_l4 at 32 px: what a knob sets does not depend on the size."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(bench, "MODEL", "volo_h2_l4")
    monkeypatch.setattr(bench, "IMG_SIZE", 32)
    for value in ("1", "0"):
        for other in KNOBS:
            monkeypatch.setenv(other, value if other == env else "0")
        sb, state, data = bench.make_step(torch.device("cpu"), 2)
        on = value == "1"
        ema_dtypes = {t.dtype for tree in state.ema_params for t in tree.values()}
        assert ema_dtypes == {torch.bfloat16 if on and env == KNOBS[0] else torch.float32}
        assert isinstance(state.optimizer, AdamWBf16Mu) == (on and env == KNOBS[1])
        target = sb.build_target(data, bench.IMG_SIZE)
        assert isinstance(target, dict) == (on and env == KNOBS[2])


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.delenv("AUTOPROG_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench.main()


def test_time_step_counts_its_steps_and_refuses_a_non_finite_loss():
    class Steps:
        def __init__(self, loss):
            self.calls, self.loss = 0, loss

        def train_step(self, state, batch, lr, *, r, keep):
            self.calls += 1
            return {"loss": torch.tensor(self.loss)}

    sb = Steps(1.0)
    batch = {"image": torch.zeros(1)}
    assert bench.time_step(sb, None, batch, 1e-3, r=32, iters=4, warmup=2) > 0
    assert sb.calls == 6
    with pytest.raises(RuntimeError, match="non-finite"):
        bench.time_step(Steps(float("nan")), None, batch, 1e-3, r=32, iters=1, warmup=0)


def test_bench_parts_prints_its_rows_and_segments(monkeypatch, capsys):
    """`scripts/bench_parts.py` on the CPU with the bench's recipe shrunk to
    volo_h2_l4 at 32 px (the full width takes minutes a step here): every
    row, the derived segments as differences of the rows, one JSON line."""
    from autoprog_tpu_torch.scripts import bench_parts
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    for env in KNOBS:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(bench, "MODEL", "volo_h2_l4")
    monkeypatch.setattr(bench, "IMG_SIZE", 32)
    result = bench_parts.main(["2", "--loss-bisect"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    rows = result["rows"]
    assert list(rows) == ["full step", "no outlookers", "no transformers",
                          "stem+post+heads+opt only", "cls-only full step",
                          "cls-only stem+post+heads+opt", "optimizer+4xEMA only",
                          "eval fwd (full)", "model fwd only"]
    assert all(v > 0 for v in rows.values())
    assert result["card"] == "cpu" and result["batch"] == 2
    d = result["derived"]
    assert d["outlooker segment"] == rows["full step"] - rows["no outlookers"]
    assert d["transformer segment"] == rows["full step"] - rows["no transformers"]
