"""`autoprog_tpu_torch.bench`, the port of the repo's headline `bench.py`, on
the CPU: the output contract (exactly one JSON line on stdout with the four
keys of the JAX script, per-stage lines on stderr), the refused knobs and the
device policy. Times taken here say nothing about the card; chip_smoke.py
runs the same `main()` there.
"""

import json
import os

import pytest
import torch

from autoprog_tpu_torch import bench


def test_main_prints_one_json_line_with_the_four_keys(monkeypatch, capsys):
    """CPU-sized run (batch 8, one timed step per configuration) of the full
    volo_d1 recipe and the four stage configs."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    for env, _ in bench._REFUSED_KNOBS:
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


@pytest.mark.parametrize("env,flag", bench._REFUSED_KNOBS)
def test_knobs_of_features_that_are_not_ported_are_refused(monkeypatch, env, flag):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(env, "1")
    with pytest.raises(NotImplementedError, match=env):
        bench.main()
    monkeypatch.setenv(env, "0")
    bench.bf16_state_knobs()


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
