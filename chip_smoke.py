#!/usr/bin/env python3
"""Smoke run of the PyTorch port (autoprog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. device: name, nvidia-smi name and power limit, TF32 flags (set off);
  2. build: nvcc builds the CUDA kernels from csrc/ (build/kernels/);
  3. kernel vs plain: K1 forward and backward against their plain PyTorch
     twins at the volo_d1 shapes (B=32, C=384, 12 heads, n = 64/100/144/196)
     and at the router's edge (n=1024, head_dim 128), bf16 and f32, and
     with f32 scores at n=196; and the volo_d1 forward through K1 against
     the unfused path (f32);
  4. trainer: `autoprog_tpu_torch.main.main` on synthetic:// with volo_d1 at
     224 px, batch 64, token labels, MixToken, drop-path 0.1 and 4 EMA
     decays, 8 train steps and one eval pass; checks finite losses, the
     kernel launch counts, the EMA trees and the eval line;
  5. times (CUDA events / synchronised clock, after warm-up, bf16): K1
     forward and backward against the plain twins at [128, 196, 384, 12
     heads], and the full volo_d1 train step at batch 128, 224 px, with the
     kernel and with AUTOPROG_FUSED_ATTN=0.

The line before the last is the kernel report (JSON); the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing any result.
"""

import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

TOL_ULPS = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -20}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 1 device: {name}")
    say(card)
    say(f"phase 1 tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    say(f"phase 1 versions: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, card


def phase_build():
    from autoprog_tpu_torch import _build
    t0 = time.time()
    lib = _build.build()
    dt = time.time() - t0
    _build.load()
    regs = re.findall(r"Used (\d+) registers", lib.with_suffix(".log").read_text())
    say(f"phase 2 build: {lib.name} in {dt:.1f} s (registers per kernel: {regs})")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def _tol(ref, dt_name):
    return TOL_ULPS[dt_name] * max(1.0, ref.float().abs().max().item())


def phase_kernels(torch):
    """K1 kernels vs plain twins. Tolerance: the kernel and the twin round at
    the same points and differ only in f32 summation order, which can flip
    one rounding to the working dtype: 2 ulp of the largest |value| (bf16:
    2^-6 relative; f32: 2^-20)."""
    from autoprog_tpu_torch.ops import attention as A
    worst = {"fwd": 0.0, "bwd": 0.0}
    # (B, n, heads, d, scores_f32): the four stage resolutions of volo_d1,
    # the router's edge, and the AUTOPROG_ATTN_SCORES_F32=1 variant
    shapes = ([(32, n, 12, 32, False) for n in (64, 100, 144, 196)]
              + [(4, 1024, 3, 128, False), (32, 196, 12, 32, True)])
    gen = torch.Generator("cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for B, n, H, d, sf in shapes:
            qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).to(dt)
            dout = torch.randn(B, n, H * d, device="cuda", generator=gen).to(dt)
            scale = d ** -0.5
            out = A._launch_fwd(qkv, H, scale, sf)
            torch.cuda.synchronize()
            ref = A.mhsa_fused_qkv_reference(qkv, H, scale, sf)
            dq = A._launch_bwd(qkv, dout, H, scale, sf)
            torch.cuda.synchronize()
            dref = A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale, sf)
            for tag, got, want in (("fwd", out, ref), ("bwd", dq, dref)):
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"K1 {tag} {dt_name} B={B} n={n}: bad shape or non-finite")
                e, tol = _err(got, want), _tol(want, dt_name)
                say(f"phase 3 K1 {tag} {dt_name} B={B} n={n} heads={H} d={d} "
                    f"scores_f32={int(sf)}: max_abs_err {e:.3e} (tol {tol:.3e})")
                if not e <= tol:
                    fail(f"K1 {tag} disagrees with its plain twin: {e} > {tol}")
                worst[tag] = max(worst[tag], e)
    return worst


def phase_model_parity(torch):
    """volo_d1 eval logits through K1 vs the unfused path, f32, 4 images:
    both are f32 formulas over the same weights; tolerance 1e-3 absolute on
    logits of magnitude ~1 (summation order through 18 blocks)."""
    from autoprog_tpu_torch import create_model
    torch.manual_seed(0)
    model = create_model("volo_d1").make(num_classes=1000, dtype=torch.float32).cuda()
    x = torch.randn(4, 224, 224, 3, device="cuda")
    with torch.no_grad():
        os.environ["AUTOPROG_FUSED_ATTN"] = "0"
        plain = model(x, train=False)
        os.environ["AUTOPROG_FUSED_ATTN"] = "1"
        fused = model(x, train=False)
    torch.cuda.synchronize()
    e = _err(fused, plain)
    say(f"phase 3 volo_d1 forward through K1 vs unfused, f32: max_abs_err {e:.3e} "
        f"(tol 1e-3, |logits| max {plain.abs().max().item():.3f})")
    if not (torch.isfinite(fused).all() and e <= 1e-3):
        fail("volo_d1 logits through K1 disagree with the unfused path")
    del model


def phase_trainer(torch, steps: int = 8, batch: int = 64):
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops.attention import LAUNCHES
    out = tempfile.mkdtemp(prefix="chip_smoke_")
    argv = ["synthetic://", "--model", "volo_d1", "--img-size", "224", "-b", str(batch),
            "--token-label", "--token-label-data", "synthetic", "--model-ema",
            "--model-ema-decay", "0.998", "0.9986", "0.999", "0.9996",
            "--drop-path", "0.1", "--epochs", "1", "--warmup-epochs", "0",
            "--cooldown-epochs", "0", "--lr", "1e-3", "--fake-data-size",
            str(steps * batch), "--workers", "6", "--log-interval", "1",
            "--output", out]
    os.environ["AUTOPROG_FUSED_ATTN"] = "1"
    LAUNCHES["fwd"] = LAUNCHES["bwd"] = 0
    t0 = time.time()
    best = main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    run = glob.glob(os.path.join(out, "train", "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    losses = [float(v) for v in re.findall(r"Train: 0 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    say(f"phase 4 trainer: python -m autoprog_tpu_torch.main {' '.join(argv[:-2])} "
        f"({wall:.1f} s incl. data and eval)")
    say(f"phase 4 losses: {losses}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"expected {steps} finite losses, got {losses}")
    n_attn = 14 * steps
    say(f"phase 4 launches: {launches} (train steps {steps} x 14 transformer layers "
        f"= {n_attn})")
    if launches["bwd"] != n_attn or launches["fwd"] < n_attn:
        fail(f"K1 launches {launches} do not cover 14 layers x {steps} steps")
    tests = [ln for ln in log.splitlines() if re.search(r"Test(_EMA_\S+)?: loss", ln)]
    for ln in tests:
        say("phase 4 eval: " + ln.split("autoprog_tpu_torch: ")[-1])
    if len(tests) != 5 or best is None:
        fail("the eval pass did not print a top-1 line for the model and 4 EMAs")
    ckpt = torch.load(os.path.join(run, "last.ckpt"), map_location="cpu", weights_only=False)
    params = ckpt["state_dict"]
    emas = [ckpt[f"state_dict_ema_{i}"] for i in range(4)]

    def dist(a, b):
        return math.sqrt(sum(float((a[k] - b[k]).double().pow(2).sum()) for k in a))
    d_p = [dist(e, params) for e in emas]
    d_e = [dist(emas[i], emas[j]) for i in range(4) for j in range(i + 1, 4)]
    say(f"phase 4 EMA: |ema_i - params| = {['%.3e' % v for v in d_p]}, "
        f"min |ema_i - ema_j| = {min(d_e):.3e}")
    if min(d_p) <= 0 or min(d_e) <= 0:
        fail("EMA trees equal the params or each other")
    return launches


def _time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_times(torch, card):
    from autoprog_tpu_torch.ops import attention as A
    B, n, H, d = 128, 196, 12, 32
    gen = torch.Generator("cuda").manual_seed(1)
    qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
    scale = d ** -0.5
    t = {
        "fwd": _time_cuda(torch, lambda: A._launch_fwd(qkv, H, scale, False), 50),
        "plain_fwd": _time_cuda(torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale), 20),
        "bwd": _time_cuda(torch, lambda: A._launch_bwd(qkv, dout, H, scale, False), 50),
        "plain_bwd": _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale), 20),
    }
    say(f"phase 5 K1 [B={B}, n={n}, C={H * d}, heads={H}] bf16 on {card}: "
        f"fwd {t['fwd']:.4f} ms (plain {t['plain_fwd']:.4f} ms), "
        f"bwd {t['bwd']:.4f} ms (plain {t['plain_bwd']:.4f} ms), "
        f"fwd+bwd {t['fwd'] + t['bwd']:.4f} ms (plain {t['plain_fwd'] + t['plain_bwd']:.4f} ms)")
    return t


def phase_step_times(torch, card, batch: int = 128, iters: int = 10):
    """Full volo_d1 train step (token labels, MixToken, drop-path 0.1,
    AdamW, 4 EMAs) on a device-resident synthetic batch; order plain,
    kernel, kernel, plain."""
    import argparse
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    args = argparse.Namespace(opt="adamw", opt_betas=None, opt_eps=None, weight_decay=0.05,
                              token_label=True, token_label_size=14, ground_truth=False,
                              dense_weight=0.5, cls_weight=1.0)
    torch.manual_seed(0)
    model = create_model("volo_d1").make(num_classes=1000, drop_path_rate=0.1,
                                         dtype=torch.bfloat16).cuda()
    decays = (0.998, 0.9986, 0.999, 0.9996)
    state = TrainState.create(model=model, optimizer=create_optimizer(args, model),
                              ema_decays=decays)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=decays,
                     num_classes=1000, token_label=True, has_token_label_data=True,
                     device=torch.device("cuda"), seed=0)
    g = torch.Generator("cuda").manual_seed(2)
    scores = torch.rand(batch, 5, 14, 14, device="cuda", generator=g)
    data = {"image": torch.randn(batch, 224, 224, 3, device="cuda", generator=g),
            "label": torch.randint(0, 1000, (batch,), device="cuda", generator=g),
            "label_scores": scores / (scores.sum(1, keepdim=True) * 1.25),
            "label_inds": torch.randint(0, 1000, (batch, 5, 14, 14), device="cuda",
                                        generator=g, dtype=torch.int32)}

    def run(fused: str) -> float:
        os.environ["AUTOPROG_FUSED_ATTN"] = fused
        for _ in range(3):
            sb.train_step(state, data, 1e-3, r=224)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = sb.train_step(state, data, 1e-3, r=224)["loss"]
        torch.cuda.synchronize()
        if not math.isfinite(float(loss)):
            fail(f"non-finite loss in the timed steps (AUTOPROG_FUSED_ATTN={fused})")
        return (time.perf_counter() - t0) / iters * 1e3

    torch.cuda.reset_peak_memory_stats()
    ms = {"0": [], "1": []}
    for fused in ("0", "1", "1", "0"):
        ms[fused].append(run(fused))
    os.environ["AUTOPROG_FUSED_ATTN"] = "1"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k, p = sum(ms["1"]) / 2, sum(ms["0"]) / 2
    say(f"phase 5 volo_d1 train step b={batch} 224px bf16 on {card}: "
        f"kernel {k:.2f} ms ({batch / k * 1e3:.1f} img/s; runs {ms['1']}), "
        f"AUTOPROG_FUSED_ATTN=0 {p:.2f} ms ({batch / p * 1e3:.1f} img/s; runs {ms['0']}); "
        f"peak device memory {peak:.2f} GiB")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    try:
        import autoprog_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository: {e}")
    name, card = phase_device(torch)
    phase_build()
    worst = phase_kernels(torch)
    phase_model_parity(torch)
    launches = phase_trainer(torch)
    t = phase_kernel_times(torch, card)
    phase_step_times(torch, card)
    src = "autoprog_tpu_torch/csrc/mhsa_qkv.cu"
    report = {"kernels": [
        {"name": "mhsa_qkv_fwd", "route": "cuda", "source": src,
         "replaces": "autoprog_tpu/ops/attention_pallas.py:206",
         "launches": launches["fwd"], "max_abs_err": worst["fwd"],
         "ms": t["fwd"], "plain_ms": t["plain_fwd"]},
        {"name": "mhsa_qkv_bwd", "route": "cuda", "source": src,
         "replaces": "autoprog_tpu/ops/attention_pallas.py:228",
         "launches": launches["bwd"], "max_abs_err": worst["bwd"],
         "ms": t["bwd"], "plain_ms": t["plain_bwd"]},
    ]}
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
