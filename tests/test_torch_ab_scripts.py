"""The port's A/B and accuracy scripts (`autoprog_tpu_torch/scripts/`:
ab_bf16_state, ab_sparse_tl, real_data_digits, ab_procgen, analyze_rehearsal,
ab_search_sync, rehearsal_flagship.sh) against the JAX package's scripts of
the same names, on the CPU, and the search's AUTOPROG_SYNC_SEARCH switch:

  (a) the bench scripts on the same canned bench legs (a win, a rejection, a
      failing leg, a stale verdict file, a file to merge into) write the same
      files with the same bytes and return the same code; the port's legs
      run `python -m autoprog_tpu_torch.bench` with the leg's switches;
  (b) the repo's digits.csv.gz loads to sklearn's `load_digits()` arrays, and
      `materialize` writes the same file tree with the same pixels;
  (c) `common_flags` equals the JAX lists on the CPU and on an accelerator;
  (d) the log parsers give the same values and print the same tables on the
      same logs, a real log of the port's `main_prog --auto-grow` among them;
  (e) `ab_procgen --summarize-only` prints the JAX script's table and exits
      as it does (4 where no pair completed);
  (f) `main_prog --auto-grow` with and without AUTOPROG_SYNC_SEARCH=1: the
      same decision, every train step's loss and the final parameters bit
      for bit, the probe losses within 1e-6 relative (the switch sums them
      in float64 on the host), both probe log lines in the JAX words. The
      time probe is replaced by a fixed function of the candidate, so that
      the decision does not hang on the CPU's clock;
  (g) the port's rehearsal_flagship.sh runs the JAX script's flags; only
      the entry points differ;
and ab_procgen's two trainers in one process: each arm's log holds its own
lines only, and the fixed arm run again after both gives the same result;
and a loader's close after a full epoch returns at once.
"""

import argparse
import glob
import io
import json
import os
import re
import shlex
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from autoprog_tpu_torch import main_prog as port_main_prog
from autoprog_tpu_torch.prog import autogrow
from autoprog_tpu_torch.scripts import ab_bf16_state as t_bf16
from autoprog_tpu_torch.scripts import ab_procgen as t_procgen
from autoprog_tpu_torch.scripts import ab_search_sync as t_sync
from autoprog_tpu_torch.scripts import ab_sparse_tl as t_sparse
from autoprog_tpu_torch.scripts import analyze_rehearsal as t_analyze
from autoprog_tpu_torch.scripts import real_data_digits as t_digits
from autoprog_tpu_torch.train.steps import StepBuilder
from scripts import ab_bf16_state as j_bf16
from scripts import ab_procgen as j_procgen
from scripts import ab_search_sync as j_sync
from scripts import ab_sparse_tl as j_sparse
from scripts import analyze_rehearsal as j_analyze
from scripts import real_data_digits as j_digits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Equal bits from two CPU runs need a fixed reduction order: one
    intra-op thread (MKL hands a loaded machine's process fewer threads than
    asked, and so another order; beside other test workers, 8 threads a
    process also ran these trainers 30-50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------- (a) bench scripts

def leg_json(value):
    return json.dumps({"metric": "volo_d1_train_imgs_per_sec_per_chip", "value": value,
                       "unit": "img/s", "vs_baseline": 1.5})


#: per case: img/s of each leg by its switches (None: the leg fails), and the
#: verdict file that stands in output/ before the run (None: no file)
OLD_VERDICT = json.dumps({"ema_bf16": True, "mu_bf16": False,
                          "legs_img_per_s": {"f32state": 1.0}}, indent=1)
BENCH_CASES = {
    "win": ({"00": 1000.0, "10": 1015.5, "11": 1004.0, "s0": 1000.0, "s1": 1012.0}, None),
    "rejection": ({"00": 1000.0, "10": 1009.9, "11": 990.0, "s0": 1000.0, "s1": 1009.0}, None),
    "failing_leg": ({"00": 1000.0, "10": None, "11": 1020.0, "s0": 1000.0, "s1": None}, None),
    "stale_verdict": ({"00": 1000.0, "10": 1001.0, "11": 1002.0, "s0": 1000.0, "s1": 990.0},
                      OLD_VERDICT),
    "merge": ({"00": 1000.0, "10": 1030.0, "11": 1040.0, "s0": 1000.0, "s1": 1100.0},
              OLD_VERDICT),
    "merge_unreadable": ({"00": 900.0, "10": 1000.0, "11": 950.0, "s0": 1000.0, "s1": 1010.0},
                         "{not json"),
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
@pytest.mark.parametrize("script", ["ab_bf16_state", "ab_sparse_tl"])
def test_bench_scripts_write_what_the_jax_scripts_write(script, case, tmp_path, monkeypatch):
    legs, verdict = BENCH_CASES[case]
    calls = []

    def fake_run(cmd, cwd=None, env=None, capture_output=False, text=False, **kw):
        calls.append((cmd, cwd, env))
        value = legs["s" + env["AUTOPROG_SPARSE_TL"] if script == "ab_sparse_tl" else
                     env["AUTOPROG_BENCH_EMA_BF16"] + env["AUTOPROG_BENCH_MU_BF16"]]
        if value is None:
            return subprocess.CompletedProcess(cmd, 1, "Traceback ...\nRuntimeError: boom\n", "")
        return subprocess.CompletedProcess(cmd, 0, "bench stage lines\n" + leg_json(value) + "\n",
                                           "per-stage lines\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    for var in ("AUTOPROG_BENCH_EMA_BF16", "AUTOPROG_BENCH_MU_BF16", "AUTOPROG_SPARSE_TL"):
        monkeypatch.delenv(var, raising=False)
    jmod, tmod = (j_bf16, t_bf16) if script == "ab_bf16_state" else (j_sparse, t_sparse)
    got = {}
    for side, mod in (("jax", jmod), ("port", tmod)):
        out = str(tmp_path / side / "output")
        os.makedirs(out)
        if verdict is not None:
            with open(os.path.join(out, "bench_autotune.json"), "w") as f:
                f.write(verdict)
        monkeypatch.setattr(mod, "OUT", out)
        calls.clear()
        rc = mod.main()
        got[side] = (rc, tree(out), [(c, e) for c, _, e in calls])
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1], "nothing written"
    if case == "failing_leg":
        assert got["port"][0] == 1
    # the port's legs: the port's bench as a module, from the repo's root,
    # each with the leg's switches and the JAX legs' switches
    port_calls, jax_calls = got["port"][2], got["jax"][2]
    assert len(port_calls) == len(jax_calls) > 0
    for (pc, pe), (jc, je) in zip(port_calls, jax_calls):
        assert pc == [sys.executable, "-m", "autoprog_tpu_torch.bench"]
        assert jc[1].endswith("bench.py")
        knobs = {k: v for k, v in pe.items() if k.startswith("AUTOPROG_")}
        assert knobs == {k: v for k, v in je.items() if k.startswith("AUTOPROG_")}
        assert knobs in [k for _, k in tmod.LEGS]


def test_port_bench_ignores_the_verdict_file():
    """The port's bench reads none of bench_autotune.json: a verdict left in
    output/ does not change what the headline bench measures."""
    src = open(os.path.join(REPO, "autoprog_tpu_torch", "bench.py")).read()
    code = src.split('"""', 2)[2]
    assert "bench_autotune" not in code


# ---------------------------------------------------------------- (b) digits data

def test_digits_copy_loads_as_sklearn_does():
    from sklearn.datasets import load_digits
    d = load_digits()
    images, target = t_digits.load_digits()
    assert images.dtype == d.images.dtype and target.dtype == d.target.dtype
    assert np.array_equal(images, d.images) and np.array_equal(target, d.target)
    sk = os.path.join(os.path.dirname(__import__("sklearn").__file__), "datasets", "data",
                      "digits.csv.gz")
    assert open(t_digits.DIGITS, "rb").read() == open(sk, "rb").read()


def test_digits_materialize_writes_the_jax_tree(tmp_path):
    from PIL import Image
    j_digits.materialize(str(tmp_path / "jax"))
    t_digits.materialize(str(tmp_path / "port"))
    jt, tt = tree(str(tmp_path / "jax")), tree(str(tmp_path / "port"))
    assert sorted(jt) == sorted(tt) and len(jt) == 1797 + 1
    # 355 val, not the 360 the JAX script's summary line says (its classes
    # are not all of 180 scans)
    assert sum(p.startswith("val") for p in tt) == 355
    for rel in jt:
        if rel == "DONE":
            continue
        a = np.asarray(Image.open(io.BytesIO(jt[rel])))
        b = np.asarray(Image.open(io.BytesIO(tt[rel])))
        assert a.shape == b.shape == (64, 64, 3) and np.array_equal(a, b), rel


# ---------------------------------------------------------------- (c) flag lists

PROCGEN_ARGS = types.SimpleNamespace(num_classes=10, img_size=64, batch=32, train_size=512,
                                     workers=4)


@pytest.mark.parametrize("where", ["cpu", "accelerator"])
@pytest.mark.parametrize("script", ["real_data_digits", "ab_procgen"])
def test_common_flags_are_the_jax_lists(script, where, monkeypatch):
    import jax
    from autoprog_tpu_torch import platform
    if where == "cpu":
        monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    else:
        monkeypatch.setattr(platform, "default_device", lambda: torch.device("cuda"))
        monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    if script == "real_data_digits":
        for seed in (42, 7):
            assert t_digits.common_flags(seed) == j_digits.common_flags(seed)
    else:
        assert t_procgen.common_flags(PROCGEN_ARGS, 123) == \
            j_procgen.common_flags(PROCGEN_ARGS, 123)
    want = "--no-bf16" if where == "cpu" else "--uint8-pipe"
    assert t_digits.card_flags() == [want]


# ---------------------------------------------------------------- (f) the search switch

AUTO = ["synthetic://", "--model", "volo_h2_l4", "--num-classes", "8", "-b", "16",
        "--warmup-epochs", "1", "--cooldown-epochs", "0", "--lr", "1e-3", "--workers", "0",
        "--fake-data-size", "64", "--no-bf16", "--img-size", "64", "--epochs", "4",
        "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5", "--drop-path", "0.0",
        "--auto-grow", "--search-epochs", "1", "--search-probe-steps", "2",
        "--load-with-clone-ema", "--model-ema", "--model-ema-decay", "0.9", "0.95",
        "0.99", "0.995"]


def fixed_time(self, state, batch, *, r, keep=None, iters=10, params=None, drop_gen=None,
               mix_gen=None):
    """A time probe that depends on the candidate alone."""
    layers = sum(sum(k) for k in keep) if keep is not None else 4
    return 1e-3 * (r / 32) ** 2 * layers


@pytest.fixture(scope="module")
def search_runs(tmp_path_factory):
    """The tiny search twice in this process, with and without the switch:
    its log, the probes' results, every train step's loss, the decision and
    the final parameters and EMA trees."""
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        mp.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
        mp.setattr(StepBuilder, "chained_throughput_probe", fixed_time)
        record = {}
        orig_step, orig_probe = StepBuilder.train_step, autogrow.probe_candidate

        def train_step(self, *a, **k):
            m = orig_step(self, *a, **k)
            record["losses"].append(m["loss"].detach().clone())
            return m

        def probe_candidate(ctx, batches, **k):
            out = orig_probe(ctx, batches, **k)
            record["probes"].append((k["r"], k["keep"], out["loss"]))
            return out

        mp.setattr(StepBuilder, "train_step", train_step)
        mp.setattr(autogrow, "probe_candidate", probe_candidate)
        for tag in ("sync", "desync"):
            if tag == "sync":
                mp.setenv("AUTOPROG_SYNC_SEARCH", "1")
            else:
                mp.delenv("AUTOPROG_SYNC_SEARCH", raising=False)
            record.update(losses=[], probes=[])
            out = tmp_path_factory.mktemp(tag)
            port_main_prog.main(AUTO + ["--output", str(out)])
            ctx = port_main_prog.LAST_CTX
            log = glob.glob(str(out / "train" / "*" / "log.txt"))
            assert len(log) == 1
            runs[tag] = dict(
                log=log[0], out=str(out), losses=list(record["losses"]),
                probes=list(record["probes"]),
                history=[{k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                          for k, v in e.items()} for e in ctx.stage_history],
                params={k: v.detach().clone() for k, v in ctx.state.params.items()},
                ema=[{k: v.clone() for k, v in t.items()} for t in ctx.state.ema_params])
    finally:
        mp.undo()
    return runs


def test_search_switch_takes_the_same_decision(search_runs):
    s, d = search_runs["sync"], search_runs["desync"]
    assert s["history"] == d["history"] and len(s["history"]) >= 2
    dec = [re.findall(r"auto grow decision: r=\d+ l=\d+", open(r["log"]).read())
           for r in (s, d)]
    assert dec[0] == dec[1] and len(dec[0]) == 1


def test_search_switch_leaves_every_step_bit_equal(search_runs):
    s, d = search_runs["sync"], search_runs["desync"]
    assert len(s["losses"]) == len(d["losses"]) > 0
    for a, b in zip(s["losses"], d["losses"]):
        assert torch.equal(a, b)
    assert s["params"].keys() == d["params"].keys()
    for k in s["params"]:
        assert torch.equal(s["params"][k], d["params"][k]), k
    assert len(s["ema"]) == len(d["ema"]) == 4
    for ea, eb in zip(s["ema"], d["ema"]):
        assert all(torch.equal(ea[k], eb[k]) for k in ea)
    # the supernet grid the log prints, the same to every digit
    grids = [re.findall(r"TrainSuper: .*", open(r["log"]).read()) for r in (s, d)]
    assert grids[0] == grids[1] and grids[0]


def test_search_switch_probe_losses_agree(search_runs):
    s, d = search_runs["sync"], search_runs["desync"]
    assert [(r, k) for r, k, _ in s["probes"]] == [(r, k) for r, k, _ in d["probes"]]
    assert len(s["probes"]) == 8   # 4 candidates, 2 rounds
    for (_, _, a), (_, _, b) in zip(s["probes"], d["probes"]):
        assert abs(a - b) <= 1e-6 * abs(b)


def test_search_logs_carry_the_jax_probe_lines(search_runs):
    jax_words = re.compile(r"probe r\d+ keep=(full|\d+): loss probe \(first dispatch compiles\)")
    for r in search_runs.values():
        text = open(r["log"]).read()
        assert len(jax_words.findall(text)) == 8
        assert len(re.findall(r"probe r\d+: chained time probe \(compile\+warm\)", text)) == 4
        assert "kernel launches: {'K1': {'fwd': 0, 'bwd': 0}, 'K2': {'fwd': 0, 'bwd': 0}, " \
            "'LN': {'fwd': 0, 'bwd': 0}}" in text


# ---------------------------------------------------------------- (d) log parsing

LINE = "2026-01-02 03:04:{:02d},{:03d} INFO autoprog_tpu_torch: {}"


def fabricated_rehearsal(kind):
    """A log in the trainers' words with two attempts' worth of lines, or one
    cut before its end ("killed")."""
    msgs = ["Scheduled epochs: 3",
            "stage 0: {'r': 128, 'h': 12, 'l': 9, 'dp': 0.0} (batch splits 1)",
            "Train: 0 [   0/64]  Loss: 6.9  LR: 1e-3  0.0 img/s  Data: 0.5s",
            "Train: 0 [  50/64]  Loss: 6.8  LR: 1e-3  2010.5 img/s  Data: 0.0s",
            "Train: 0 [  63/64]  Loss: 6.7  LR: 1e-3  2040.1 img/s  Data: 0.0s",
            "Test: loss 6.9012  Acc@1 0.1000  Acc@5 0.5000",
            "TrainSuper: 1 [   0/64] sampled r160 l12  All Loss: r0_l0: 6.9",
            "TrainSuper: 1 [  63/64] sampled r128 l9  All Loss: r0_l0: 6.8",
            "auto grow decision: r=160 l=12",
            "stage 1: {'r': 160, 'h': 12, 'l': 12, 'dp': 0.0} (batch splits 1)",
            "Train: 2 [   0/64]  Loss: 6.6  LR: 1e-3  0.0 img/s  Data: 0.4s",
            "Train: 2 [  63/64]  Loss: 6.5  LR: 1e-3  1500.2 img/s  Data: 0.0s",
            "Test: loss 6.7512  Acc@1 0.3000  Acc@5 1.1000"]
    if kind != "killed":
        msgs += ["*** Best metric: 0.3 (epoch 2)", "total train time: 42.5s"]
    return "\n".join(LINE.format(i, 7 * i, m) for i, m in enumerate(msgs)) + "\n"


@pytest.fixture(scope="module")
def logs(search_runs, tmp_path_factory):
    """Run directories (`<out>/train/<run>/log.txt`) holding each log kind."""
    root = tmp_path_factory.mktemp("logs")
    texts = {"port_auto_grow": open(search_runs["desync"]["log"]).read(),
             "port_auto_grow_sync": open(search_runs["sync"]["log"]).read(),
             "rehearsal": fabricated_rehearsal("done"),
             "killed": fabricated_rehearsal("killed"),
             "empty": ""}
    out = {}
    for name, text in texts.items():
        d = root / name / "train" / "20260102-030400-volo_h12_l18-prog"
        d.mkdir(parents=True)
        (d / "log.txt").write_text(text)
        out[name] = str(root / name)
    out["no_run"] = str(root / "no_run")
    return out


LOG_KINDS = ["port_auto_grow", "port_auto_grow_sync", "rehearsal", "killed", "empty", "no_run"]


def same(a, b):
    """Equal, NaN equal to NaN."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return a == b


@pytest.mark.parametrize("kind", LOG_KINDS)
def test_log_parsers_agree(kind, logs, capsys):
    out = logs[kind]
    assert same(t_digits._train_time(out), j_digits._train_time(out))
    assert same(t_procgen._train_time(out), j_procgen._train_time(out))
    assert same(t_procgen._completed_result(out), j_procgen._completed_result(out))
    if kind == "no_run":
        return
    log = glob.glob(os.path.join(out, "train", "*", "log.txt"))[0]
    assert same(t_sync.parse(log), j_sync.parse(log))
    captured = []
    for mod in (j_analyze, t_analyze):
        mod.summarize(log, "autoprog")
        mod.summarize([log, log], "autoprog (stitched)")
        captured.append(capsys.readouterr().out)
    assert captured[0] == captured[1] and "=== autoprog" in captured[0]
    if kind.startswith("port_auto_grow"):
        per_probe, n, search_s = t_sync.parse(log)
        assert n == 7 and per_probe > 0 and search_s > 0
        assert "decision: r=" in captured[1] and "total train-loop time" in captured[1]
        assert t_procgen._completed_result(out) is not None


# ---------------------------------------------------------------- (e) ab_procgen's exits

def completed_arm(root, label, seed, best, secs):
    d = os.path.join(root, f"{label}_s{seed}", "train", "20260102-030400-volo_h4_l8-x")
    os.makedirs(d)
    with open(os.path.join(d, "log.txt"), "w") as f:
        f.write(LINE.format(1, 0, f"*** Best metric: {best} (epoch 29)") + "\n" +
                LINE.format(2, 0, f"total train time: {secs}s") + "\n")


PROCGEN_EXITS = {
    "one_pair": (["--summarize-only"], [("fixed", 42, 71.25, 301.5),
                                       ("autoprog", 42, 70.5, 214.0)], None),
    "empty_root": (["--summarize-only"], [], 4),
    "one_arm": (["--summarize-only", "--seeds", "42", "7"], [("fixed", 7, 60.0, 10.0)], 4),
    "deadline_passed": (["--deadline-ts", "1", "--seeds", "42"], [], 4),
    "deadline_after_reuse": (["--deadline-ts", "1", "--seeds", "7", "42"],
                             [("fixed", 7, 55.0, 12.0), ("autoprog", 7, 58.5, 9.0)], None),
}


@pytest.mark.parametrize("case", sorted(PROCGEN_EXITS))
def test_ab_procgen_exits_as_the_jax_script(case, tmp_path, monkeypatch):
    flags, arms, code = PROCGEN_EXITS[case]
    printed = []
    for side, mod in (("jax", j_procgen), ("port", t_procgen)):
        root = str(tmp_path / side)
        os.makedirs(root)
        for arm in arms:
            completed_arm(root, *arm)
        monkeypatch.setattr(sys, "argv", ["ab_procgen.py", "--root", root] + flags)
        buf = io.StringIO()
        with redirect_stdout(buf):
            if code is None:
                mod.main()
            else:
                with pytest.raises(SystemExit) as e:
                    mod.main()
                assert e.value.code == code
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] and printed[1]
    if case == "one_pair":
        assert "[reuse] fixed s42: top1 71.25 (302s)" in printed[1]
        assert "train-time speedup 1.41x, top-1 delta -0.75" in printed[1]


# ---------------------------------------------------------------- (g) the shell script

def invocations(path):
    """COMMON's flags, and each python command line's arguments after its
    entry point, `$COMMON` expanded, redirections dropped."""
    text = open(path).read().replace("\\\n", " ")
    common = shlex.split(re.search(r'COMMON="([^"]*)"', text).group(1))
    lines = []
    for line in text.splitlines():
        words = shlex.split(line.split(">")[0], comments=True)
        if words[:1] != ["python"]:
            continue
        entry, rest = (words[1:3], words[3:]) if words[1] == "-m" else (words[1:2], words[2:])
        expanded = [w for x in rest for w in (common if x == "$COMMON" else [x])]
        lines.append((" ".join(entry), expanded))
    default_out = re.search(r"OUT=\$\{1:-([^}]*)\}", text).group(1)
    return common, lines, default_out


def test_rehearsal_script_runs_the_jax_flags():
    jc, jl, jout = invocations(os.path.join(REPO, "scripts", "rehearsal_flagship.sh"))
    tc, tl, tout = invocations(os.path.join(REPO, "autoprog_tpu_torch", "scripts",
                                            "rehearsal_flagship.sh"))
    assert tc == jc and "--fake-data-size" in tc
    assert [a for _, a in tl] == [a for _, a in jl] and len(tl) == 3
    assert [e for e, _ in jl] == ["main_prog.py", "main.py", "validate.py"]
    assert [e for e, _ in tl] == ["-m autoprog_tpu_torch.main_prog", "-m autoprog_tpu_torch.main",
                                  "-m autoprog_tpu_torch.validate"]
    assert tout == "output/rehearsal"
    assert 'model_best.ckpt' in open(os.path.join(REPO, "autoprog_tpu_torch", "scripts",
                                                  "rehearsal_flagship.sh")).read()


# ---------------------------------------------------------------- two trainers, one process

def test_ab_procgen_arms_share_a_process_cleanly(tmp_path, monkeypatch):
    """Both arms of one seed in this process at a tiny size: the table is
    printed, each arm's log holds its own run only, and the fixed arm run
    once more after both gives the same best metric and train losses."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(StepBuilder, "chained_throughput_probe", fixed_time)
    root = str(tmp_path / "runs")
    flags = ["--epochs", "2", "--train-size", "64", "--num-classes", "4", "--img-size", "32",
             "-b", "16", "--model", "volo_h2_l4", "--stages", "2", "--seeds", "42",
             "--workers", "0", "--root", root]
    monkeypatch.setattr(sys, "argv", ["ab_procgen"] + flags)
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_procgen.main()
    assert "[seed 42] fixed" in buf.getvalue() and "train-time speedup" in buf.getvalue()
    fixed_log = glob.glob(os.path.join(root, "fixed_s42", "train", "*", "log.txt"))
    auto_log = glob.glob(os.path.join(root, "autoprog_s42", "train", "*", "log.txt"))
    assert len(fixed_log) == len(auto_log) == 1
    fixed_text, auto_text = open(fixed_log[0]).read(), open(auto_log[0]).read()
    assert "auto grow decision" not in fixed_text and "TrainSuper" not in fixed_text
    assert "auto grow decision" in auto_text
    for text in (fixed_text, auto_text):
        assert text.count("*** Best metric") == 1 and text.count("total train time") == 1
        assert text.count("kernel launches:") == 1
    # the fixed arm again, after the AutoProg arm ran in this process
    again = str(tmp_path / "again")
    a = argparse.Namespace(model="volo_h2_l4", epochs=2, num_classes=4, img_size=32,
                                     batch=16, train_size=64, workers=0)
    best, _ = t_procgen.run_fixed(a, again, 42)
    first = t_procgen._completed_result(os.path.join(root, "fixed_s42"))
    assert best == first[0]
    again_text = open(glob.glob(os.path.join(again, "train", "*", "log.txt"))[0]).read()
    losses = [re.findall(r"Loss: ([0-9.]+)", t) for t in (fixed_text, again_text)]
    assert losses[0] == losses[1] and losses[0]


def test_loader_close_after_a_full_epoch_is_prompt():
    """The accuracy scripts run two trainers in one process, and every
    trainer closes its loaders after full epochs. With 2 workers, a close
    after a full epoch returns at once (it waited 10 s on a lock that a
    killed idle worker held), and the workers are gone."""
    import time
    from autoprog_tpu_torch.data.dataset import create_dataset
    from autoprog_tpu_torch.data.loader import create_loader
    ds = create_dataset("", "synthetic://", split="train", is_training=True, num_classes=4,
                        fake_size=64, image_size=32, seed=3)
    loader = create_loader(ds, input_size=32, batch_size=16, is_training=True, num_workers=2,
                           seed=3)
    loader.set_epoch(0)
    assert sum(1 for _ in loader) == 4
    workers = list(loader._pool._pool)
    t0 = time.time()
    loader.close()
    assert time.time() - t0 < 3.0
    assert loader._pool is None and not any(p.is_alive() for p in workers)
