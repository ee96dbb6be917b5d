"""Progressive resume of the port against the JAX package's, from the JAX
package's own checkpoints (DeiT, 3 stages of one epoch each, depth 2 -> 3
-> 4 at 32 px).

  * after a growth: both packages resume the epoch-1 checkpoint (stage 1,
    l = 3) and grow at epoch 2; the stage histories are equal entry for
    entry, and so are the steps in the last checkpoints (the step count
    restarts with each stage's fresh state);
  * into a search boundary: the port resumes the epoch-0 checkpoint (stage
    0) with `--auto-grow`, so the next epoch is a boundary whose supernet
    search must run. The resumed stage is the JAX run's stage 0 and the
    boundaries come at the JAX run's epochs; the decision depends on
    measured step times, so it is held to the candidate window.
"""

import glob

import numpy as np
import pytest

from autoprog_tpu import main_prog as jax_main_prog
from autoprog_tpu.train.checkpoint import load_checkpoint_file as jax_load
from autoprog_tpu_torch import main_prog
from autoprog_tpu_torch.prog import autogrow
from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file

CFG = ["synthetic://", "--model", "deit_h2_l4", "--num-classes", "8", "-b", "16",
       "--warmup-epochs", "1", "--cooldown-epochs", "0", "--lr", "1e-3", "--workers", "0",
       "--fake-data-size", "32", "--no-bf16", "--img-size", "32", "--epochs", "3",
       "--num-stages", "3", "--r-scale", "1.0", "--l-scale", "0.5", "--drop-path", "0.0",
       "--load-with-clone-ema", "--model-ema", "--model-ema-decay", "0.9"]


def plain(entry):
    def conv(v):
        if isinstance(v, (tuple, list)):
            return tuple(conv(x) for x in v)
        return v.item() if isinstance(v, np.generic) else v
    return {k: conv(v) for k, v in entry.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_prog")
    jax_main_prog.main(CFG + ["--output", str(out)])
    hist = [plain(e) for e in jax_main_prog.LAST_CTX.stage_history]
    return glob.glob(str(out / "train" / "*"))[0], hist


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")


def test_resume_after_growth_walks_the_jax_stage_history(jax_run, tmp_path, cpu_port):
    run, full = jax_run
    assert [(e["epoch"], e["l"]) for e in full] == [(0, 2), (0, 2), (1, 3), (2, 4)]
    snap = f"{run}/checkpoint-1.ckpt"
    assert jax_load(snap)["arch"] == "deit_h2_l3"
    assert main_prog.main(CFG + ["--resume", snap, "--output", str(tmp_path / "port")]) \
        is not None
    got = [plain(e) for e in main_prog.LAST_CTX.stage_history]
    jax_main_prog.main(CFG + ["--resume", snap, "--output", str(tmp_path / "jax")])
    want = [plain(e) for e in jax_main_prog.LAST_CTX.stage_history]
    assert got == want
    assert [(e["epoch"], e["l"]) for e in got] == [(2, 3), (2, 4)]
    port_last = load_checkpoint_file(glob.glob(str(tmp_path / "port/train/*/last.ckpt"))[0])
    jax_last = jax_load(glob.glob(str(tmp_path / "jax/train/*/last.ckpt"))[0])
    assert port_last["arch"] == jax_last["arch"] == "deit_h2_l4"
    assert port_last["step"] == int(jax_last["step"]) == 2     # 1 epoch x 2 steps
    assert plain(port_last["stage_info"]) == plain(jax_last["stage_info"])


def test_resume_into_a_search_boundary_runs_the_search(jax_run, tmp_path, cpu_port):
    run, full = jax_run
    snap = f"{run}/checkpoint-0.ckpt"
    assert jax_load(snap)["arch"] == "deit_h2_l2"
    best = main_prog.main(CFG + ["--auto-grow", "--search-epochs", "1",
                                 "--search-probe-steps", "1", "--search-time-iters", "1",
                                 "--resume", snap, "--output", str(tmp_path)])
    assert best is not None
    hist = [plain(e) for e in main_prog.LAST_CTX.stage_history]
    # the resumed stage is the JAX run's stage 0, the boundaries its own
    assert {k: v for k, v in hist[0].items() if k != "epoch"} == \
        {k: v for k, v in full[1].items() if k not in ("epoch", "stage")}
    assert [(e["epoch"], e.get("stage")) for e in hist] == \
        [(1, None)] + [(e["epoch"], e["stage"]) for e in full[2:]]
    r_list, _, l_list = autogrow.candidate_window((32, 32, 32), (2, 2, 2), (2, 3, 4),
                                                  32, 2, 2, 1)
    assert hist[1]["r"] in r_list and hist[1]["l"] in l_list
    assert hist[-1]["l"] == 4
    log = open(glob.glob(str(tmp_path / "train" / "*" / "log.txt"))[0]).read()
    assert log.count("auto grow decision") == 1
    assert glob.glob(str(tmp_path / "train" / "*" / "last-search.ckpt"))
