#!/usr/bin/env python3
"""Smoke run of the PyTorch port (autoprog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero; nothing falls
back to the CPU or to a plain twin):
  1. device: name, nvidia-smi name and power limit, TF32 flags (set off);
  2. build: nvcc builds the CUDA kernels from csrc/ (build/kernels/), one
     compiler process per source, all at once;
  3. kernel vs plain, on the card, bf16 and f32, tolerance 2 ulp of the
     largest value: K1 forward and backward at the volo_d1 shapes (B=32,
     C=384, 12 heads, n = 64/100/144/196), at the DeiT shapes (n = 197 and
     198, head_dim 64), at the router's edge (n=1024, head_dim 128) and with
     f32 scores; K5 (separate q, k, v; contiguous and as views of one
     buffer) at the same shapes; every schedule variant (twophase,
     twophase_bf16s, pipelined) and every G-images-per-block variant (order
     phase or loop, G = 1, 2, 4; forward and backward) against its twin and
     against K1's launch at the same score type; K2 forward and backward at
     B=32, C=192, 6 heads, H=W=16/20/24/28 and at an odd shape (H=10, W=6,
     head_dim 48); K3 and K4 at n=196. Then the volo_d1 f32 forward through
     K1 against the unfused MHSA, and with AUTOPROG_FUSED_OUTLOOK=1 against
     =0 (1e-3);
  4. fixed trainer: `autoprog_tpu_torch.main.main` on synthetic:// with
     volo_d1 at 224 px, batch 64, token labels, MixToken, drop-path 0.1 and 4
     EMA decays, on the port's defaults (K1 and K2 on), 4 train steps and one
     eval pass; checks finite losses, the launch counts of K1 (14 per step)
     and K2 (4 per step), the EMA trees and the eval line;
  5. progressive trainer: `autoprog_tpu_torch.main_prog.main` with
     `--auto-grow --num-stages 2` on volo_d1 at full width (224 px, batch 64,
     token labels, MixToken, 4 EMA decays, clone-ema growth),
     AUTOPROG_FUSED_OUTLOOK=1 and AUTOPROG_FUSED_ATTN=1: the supernet
     search, its decision, the shrink and the growth to r=224, l=18; checks
     finite losses, the decision line, the stage history and that K2's
     backward ran once per outlooker layer of every train and timed-probe
     step (4 per full-depth step) and K1's once per transformer layer (14);
  6. DeiT: `autoprog_tpu_torch.main.main` with deit_small_patch16_224 at
     full width (384, 12 layers, 6 heads, 224 px, batch 64, bf16), 4 train
     steps and one eval pass; finite losses; K1 launched 12 times per step,
     forward and backward; two steps of the distilled variant; the step time
     on a device-resident batch;
  7. measurement entry points: `scripts.bench_attn.main` and
     `scripts.bench_attn_x.main` at B = 128 (their tables) and
     `autoprog_tpu_torch.bench.main` (one JSON line: img/s of the full
     volo_d1 step at batch 128 and the progressive schedule's `vs_baseline`);
     checks value > 0, vs_baseline > 0 and that K5 and every variant were
     launched;
  8. times (CUDA events / synchronised clock, after warm-up, bf16), on the
     card named beside them: K1 at [128, 196, 384, 12 heads] with
     `F.scaled_dot_product_attention` as its library yardstick; one
     K5 and every variant at the same shape, each beside its twin and SDPA; one
     outlooker layer's op at [128, 28, 28, 192] through the unfused path, K2,
     K3 and K4, forward and forward + backward; the attend kernel alone;
     and the full volo_d1 train step at batch 128, 224 px, K1 on against
     AUTOPROG_FUSED_ATTN=0 and then AUTOPROG_FUSED_OUTLOOK 0, 1, 1, 0, with
     peak memory.

The line before the last is the kernel report (JSON): for each kernel its
launches on its path (K1 and K2: phases 4 to 6; K3, K4: the variants run
of phase 8; K5 and the MHSA variants: the measurement scripts of phase 7), its
worst error against the twin, its time, the twin's,
the least time the card could take (`bound_ms`, from the bytes it must move
at 3.35 TB/s and its operations at the peak of their type) and the library
call's time where one exists. The last line is {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 before printing any result.
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
# published peaks of one H100 SXM: HBM bytes/s, dense bf16 tensor-core and
# plain f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
MHSA_SRC = "autoprog_tpu_torch/csrc/mhsa_qkv.cu"
OUTLOOK_SRC = "autoprog_tpu_torch/csrc/outlook.cu"
VARIANTS_SRC = "autoprog_tpu_torch/csrc/mhsa_variants.cu"
GROUPS = [("phase", 1), ("phase", 2), ("loop", 2), ("phase", 4), ("loop", 4)]


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
    libs = _build.build()
    dt = time.time() - t0
    _build.load()
    for lib in libs:
        regs = re.findall(r"Used (\d+) registers", lib.with_suffix(".log").read_text())
        say(f"phase 2 build: {lib.name} (registers per kernel: {regs})")
    say(f"phase 2 build: {len(libs)} libraries in {dt:.1f} s, compiled side by side")


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
    # the router's edge, the AUTOPROG_ATTN_SCORES_F32=1 variant, and DeiT
    # small, plain and distilled (197 and 198 tokens, head_dim 64)
    shapes = ([(32, n, 12, 32, False) for n in (64, 100, 144, 196)]
              + [(4, 1024, 3, 128, False), (32, 196, 12, 32, True),
                 (8, 197, 6, 64, False), (8, 198, 6, 64, False)])
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


def _check(tag, worst, key, got, want, dt_name):
    if got.shape != want.shape or not bool(got.isfinite().all()):
        fail(f"{tag} {dt_name}: bad shape or non-finite")
    e, tol = _err(got, want), _tol(want, dt_name)
    say(f"phase 3 {tag} {dt_name}: max_abs_err {e:.3e} (tol {tol:.3e})")
    if not e <= tol:
        fail(f"{tag} disagrees: {e} > {tol}")
    worst[key] = max(worst.get(key, 0.0), e)


def phase_mhsa_variants(torch):
    """K5 against its twin (bf16 and f32; contiguous q, k, v and the three
    views of one qkv buffer) and against K1 at f32 scores; every schedule
    variant and every G-images-per-block variant (bf16) against its twin and
    against K1's launch at the variant's score type. Same tolerance and
    reason as K1's; against K1 the results are also compared bit for bit and
    the outcome is printed."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    worst, same = {}, {}
    gen = torch.Generator("cuda").manual_seed(5)
    shapes = [(32, n, 12, 32) for n in (64, 100, 144, 196)] + [(8, 197, 6, 64),
                                                                (4, 1024, 3, 128)]
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for B, n, H, d in shapes:
            qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).to(dt)
            dout = torch.randn(B, n, H * d, device="cuda", generator=gen).to(dt)
            scale, tag = d ** -0.5, f"B={B} n={n} heads={H} d={d}"
            k1f = A._launch_fwd(qkv, H, scale, True).view(B, n, H, d)
            k1b = A._launch_bwd(qkv, dout, H, scale, True).view(B, n, 3, H, d).unbind(2)
            views = qkv.view(B, n, 3, H, d).unbind(2)
            g4 = dout.view(B, n, H, d)
            for how, (q, k, v) in (("views", views),
                                   ("contiguous", [t.contiguous() for t in views])):
                out = A._launch_fused_fwd(q, k, v, scale)
                grads = A._launch_fused_bwd(q, k, v, g4, scale)
                torch.cuda.synchronize()
                _check(f"K5 fwd {how} {tag}", worst, "mhsa_fwd", out,
                       A.mhsa_fused_reference(q, k, v, scale), dt_name)
                _check(f"K5 fwd {how} vs K1 at f32 scores {tag}", worst, "mhsa_fwd", out, k1f,
                       dt_name)
                refs = A.mhsa_fused_backward_reference(q, k, v, g4, scale)
                for nm, got, ref, k1 in zip(("dq", "dk", "dv"), grads, refs, k1b):
                    _check(f"K5 bwd {nm} {how} {tag}", worst, "mhsa_bwd", got, ref, dt_name)
                    _check(f"K5 bwd {nm} {how} vs K1 {tag}", worst, "mhsa_bwd", got, k1,
                           dt_name)
                same["mhsa"] = same.get("mhsa", True) and torch.equal(out, k1f) and all(
                    torch.equal(a, b) for a, b in zip(grads, k1b))
    # the variants: the bench shape and DeiT's (odd n, head_dim 64)
    for B, n, H, d in [(32, 196, 12, 32), (8, 197, 6, 64)]:
        qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
        dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
        scale, tag = d ** -0.5, f"B={B} n={n} heads={H} d={d}"
        for name in V._KERNELS:
            out = V._launch(name, qkv, H, scale)
            k1 = A._launch_fwd(qkv, H, scale, V.SCORES_F32[name])
            torch.cuda.synchronize()
            _check(f"S2 {name} {tag}", worst, name, out,
                   V.mhsa_fwd_variant_reference(name, qkv, H, scale), "bfloat16")
            _check(f"S2 {name} vs K1 scores_f32={int(V.SCORES_F32[name])} {tag}", worst, name,
                   out, k1, "bfloat16")
            same[name] = same.get(name, True) and torch.equal(out, k1)
        k1f = A._launch_fwd(qkv, H, scale, True)
        k1b = A._launch_bwd(qkv, dout, H, scale, True)
        ref_f = X.group_reference(qkv, H, scale)
        ref_b = X.group_backward_reference(qkv, dout, H, scale)
        for order, G in GROUPS:
            key = X.variant_name(order, G)
            out = X._launch_group_fwd(order, G, qkv, H, scale)
            grad = X._launch_group_bwd(order, G, qkv, dout, H, scale)
            torch.cuda.synchronize()
            _check(f"S1 {key} fwd {tag}", worst, key + "_fwd", out, ref_f, "bfloat16")
            _check(f"S1 {key} fwd vs K1 at f32 scores {tag}", worst, key + "_fwd", out, k1f,
                   "bfloat16")
            _check(f"S1 {key} bwd {tag}", worst, key + "_bwd", grad, ref_b, "bfloat16")
            _check(f"S1 {key} bwd vs K1 at f32 scores {tag}", worst, key + "_bwd", grad, k1b,
                   "bfloat16")
            same[key] = same.get(key, True) and torch.equal(out, k1f) and \
                torch.equal(grad, k1b)
    say(f"phase 3 bit for bit equal to K1 at the same score type: {same}")
    # what does not fit is refused, not shrunk
    big = torch.randn(2, 1024, 3 * 2 * 64, device="cuda", generator=gen).bfloat16()
    for what, call in (("twophase at n=1024", lambda: V._launch("twophase", big, 2, 0.125)),
                       ("phase_img2 at n=1024",
                        lambda: X._launch_group_fwd("phase", 2, big, 2, 0.125))):
        try:
            call()
        except ValueError as e:
            say(f"phase 3 {what}: refused ({e})")
        else:
            fail(f"{what} should not fit a block's shared memory")
    return worst


def phase_outlook_kernels(torch):
    """K2 forward and backward and the K3 / K4 attend against their plain
    twins; same tolerance and reason as K1's."""
    from autoprog_tpu_torch.ops import outlook_fused as O
    worst = {}
    # (B, H, W, C, heads): the four stage resolutions of volo_d1 and an odd
    # shape (H != W, head_dim 48)
    shapes = [(32, r, r, 192, 6) for r in (16, 20, 24, 28)] + [(8, 10, 6, 96, 2)]
    gen = torch.Generator("cuda").manual_seed(3)
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for B, H, W, C, heads in shapes:
            v = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            logits = (2 * torch.randn(B, H // 2, W // 2, heads * 81, device="cuda",
                                      generator=gen)).to(dt)
            gout = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            scale = (C // heads) ** -0.5
            out = O._launch_fwd(v, logits, heads, scale)
            dv, dlogits = O._launch_bwd(v, logits, gout, heads, scale)
            torch.cuda.synchronize()
            tag = f"B={B} H={H} W={W} C={C} heads={heads}"
            _check(f"K2 fwd {tag}", worst, "fwd", out,
                   O.outlook_attention_fused_reference(v, logits, heads, scale), dt_name)
            rdv, rdl = O.outlook_attention_backward_reference(v, logits, gout, heads, scale)
            _check(f"K2 bwd dv {tag}", worst, "bwd", dv, rdv, dt_name)
            _check(f"K2 bwd dlogits {tag}", worst, "bwd", dlogits, rdl, dt_name)
        B, H, C, heads = 32, 28, 192, 6
        n = (H // 2) ** 2
        patches = torch.randn(B, n, 9, C, device="cuda", generator=gen).to(dt)
        att = (2 * torch.randn(B, n, 9, 9, heads, device="cuda", generator=gen)).to(dt)
        for key, hm in (("attend_hm", True), ("attend", False)):
            out = O._launch_attend(patches, att, heads, 32 ** -0.5, hm)
            torch.cuda.synchronize()
            _check(f"{'K3' if hm else 'K4'} attend B={B} n={n} C={C} heads={heads}", worst,
                   key, out,
                   O.outlook_attend_reference(patches, att, heads, 32 ** -0.5, hm), dt_name)
    return worst


def phase_outlook_model_parity(torch):
    """volo_d1 eval logits with AUTOPROG_FUSED_OUTLOOK=1 against =0, f32, 4
    images: in f32 both paths compute the same formula; tolerance 1e-3."""
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.ops.outlook_fused import LAUNCHES
    torch.manual_seed(0)
    model = create_model("volo_d1").make(num_classes=1000, dtype=torch.float32).cuda()
    x = torch.randn(4, 224, 224, 3, device="cuda")
    before = LAUNCHES["fwd"]
    with torch.no_grad():
        os.environ["AUTOPROG_FUSED_OUTLOOK"] = "0"
        plain = model(x, train=False)
        os.environ["AUTOPROG_FUSED_OUTLOOK"] = "1"
        fused = model(x, train=False)
    del os.environ["AUTOPROG_FUSED_OUTLOOK"]
    torch.cuda.synchronize()
    e = _err(fused, plain)
    say(f"phase 3 volo_d1 forward with AUTOPROG_FUSED_OUTLOOK=1 vs =0, f32: max_abs_err "
        f"{e:.3e} (tol 1e-3, |logits| max {plain.abs().max().item():.3f})")
    if LAUNCHES["fwd"] - before != 4:
        fail("volo_d1 with AUTOPROG_FUSED_OUTLOOK=1 did not launch K2 in its 4 outlookers")
    if not (torch.isfinite(fused).all() and e <= 1e-3):
        fail("volo_d1 logits through K2 disagree with the unfused path")
    del model


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


def phase_trainer(torch, steps: int = 4, batch: int = 64):
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops.attention import LAUNCHES
    from autoprog_tpu_torch.ops.outlook_fused import LAUNCHES as OUTLOOK_LAUNCHES
    out = tempfile.mkdtemp(prefix="chip_smoke_")
    argv = ["synthetic://", "--model", "volo_d1", "--img-size", "224", "-b", str(batch),
            "--token-label", "--token-label-data", "synthetic", "--model-ema",
            "--model-ema-decay", "0.998", "0.9986", "0.999", "0.9996",
            "--drop-path", "0.1", "--epochs", "1", "--warmup-epochs", "0",
            "--cooldown-epochs", "0", "--lr", "1e-3", "--fake-data-size",
            str(steps * batch), "--workers", "6", "--log-interval", "1",
            "--output", out]
    # the port's defaults on the card: K1 and K2 both on
    os.environ.pop("AUTOPROG_FUSED_ATTN", None)
    os.environ.pop("AUTOPROG_FUSED_OUTLOOK", None)
    for counts in (LAUNCHES, OUTLOOK_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    best = main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, outlook = dict(LAUNCHES), dict(OUTLOOK_LAUNCHES)
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
    say(f"phase 4 launches: K2 {outlook} (train steps {steps} x 4 outlooker layers "
        f"= {4 * steps})")
    if outlook["bwd"] != 4 * steps or outlook["fwd"] < 4 * steps:
        fail(f"K2 launches {outlook} do not cover 4 layers x {steps} steps")
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
    return launches, outlook


def phase_prog_trainer(torch, steps: int = 5, batch: int = 64):
    """The progressive trainer with the supernet search, at full width."""
    from autoprog_tpu_torch import main_prog
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.prog.depth import elastic_keep_masks
    out = tempfile.mkdtemp(prefix="chip_smoke_prog_")
    time_iters = 3
    argv = ["synthetic://", "--model", "volo_d1", "--img-size", "224", "-b", str(batch),
            "--token-label", "--token-label-data", "synthetic", "--model-ema",
            "--model-ema-decay", "0.998", "0.9986", "0.999", "0.9996",
            "--drop-path", "0.1", "--epochs", "4", "--warmup-epochs", "0",
            "--cooldown-epochs", "0", "--lr", "1e-3", "--fake-data-size",
            str(steps * batch), "--workers", "6", "--log-interval", "1",
            "--auto-grow", "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5",
            "--search-epochs", "1", "--search-probe-steps", "3", "--search-time-iters",
            str(time_iters), "--load-with-clone-ema", "--output", out]
    os.environ["AUTOPROG_FUSED_ATTN"] = "1"
    os.environ["AUTOPROG_FUSED_OUTLOOK"] = "1"
    for counts in (A.LAUNCHES, O.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    best = main_prog.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    del os.environ["AUTOPROG_FUSED_OUTLOOK"]
    k1, k2 = dict(A.LAUNCHES), dict(O.LAUNCHES)
    run = glob.glob(os.path.join(out, "train", "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    say(f"phase 5 prog trainer: python -m autoprog_tpu_torch.main_prog "
        f"{' '.join(argv[:-2])} ({wall:.1f} s incl. data, search, eval and checkpoints)")
    hist = main_prog.LAST_CTX.stage_history
    for h in hist:
        say(f"phase 5 stage: epoch {h['epoch']} r={h['r']} l={h['l']} dp={float(h['dp']):.2f}")
    decision = re.findall(r"auto grow decision: r=(\d+) l=(\d+)", log)
    table = re.findall(r"search w=.*", log)
    say(f"phase 5 search: {table[-1] if table else 'no score line'}")
    if len(decision) != 1:
        fail(f"expected one 'auto grow decision' line, got {decision}")
    best_r, best_l = int(decision[0][0]), int(decision[0][1])
    say(f"phase 5 auto grow decision: r={best_r} l={best_l}")
    if best_r not in (128, 224) or best_l not in (9, 18):
        fail("the decision lies outside the candidate window")
    if (hist[1]["r"], hist[1]["l"]) != (best_r, best_l) or \
            (hist[-1]["r"], hist[-1]["l"]) != (224, 18):
        fail(f"stage history {hist} does not follow the decision to r=224, l=18")
    sampled = [int(l) for l in re.findall(r"TrainSuper: 0 \[\s*\d+/\d+\] sampled r\d+ l(\d+)",
                                           log)]
    losses = [float(v) for v in re.findall(r"Train: \d+ \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    grid = [float(v) for line in re.findall(r"All Loss: (.*)", log)
            for v in re.findall(r": ([^;\s]+)", line)]
    say(f"phase 5 losses after the search: {losses}")
    if len(sampled) != steps or len(losses) != 3 * steps or \
            not all(math.isfinite(v) for v in losses + grid) or best is None:
        fail(f"expected {steps} supernet steps and {3 * steps} finite losses, got "
             f"{sampled} and {losses}")
    # one K2 backward per active outlooker layer and one K1 backward per
    # active transformer layer of every step that runs a backward: the
    # supernet's train steps, the timed probes (a warm-up + time_iters steps
    # per candidate) and the train steps of the three epochs after the search
    layers = {l: tuple(sum(k) for k in elastic_keep_masks(l, 9, 18)) for l in (9, 18)}
    probe_steps = (1 + time_iters) * 2                   # two resolutions per depth
    backward = [layers[l] for l in sampled] + [layers[9]] * probe_steps + \
        [layers[18]] * probe_steps + [layers[best_l]] * steps + [(4, 14)] * (2 * steps)
    want_k2, want_k1 = sum(b[0] for b in backward), sum(b[1] for b in backward)
    say(f"phase 5 launches: K2 {k2}, K1 {k1}; backward steps {len(backward)} of which "
        f"{2 * steps} at full depth (4 outlookers, 14 transformer layers each); expected "
        f"K2 bwd {want_k2}, K1 bwd {want_k1}")
    if k2["bwd"] != want_k2 or k2["fwd"] < want_k2:
        fail(f"K2 launches {k2} do not cover every outlooker layer of every step")
    if k1["bwd"] != want_k1 or k1["fwd"] < want_k1:
        fail(f"K1 launches {k1} do not cover every transformer layer of every step")
    for name in ("last-search.ckpt", "last.ckpt"):
        if not os.path.exists(os.path.join(run, name)):
            fail(f"{name} was not written")
    ckpt = torch.load(os.path.join(run, "last.ckpt"), map_location="cpu", weights_only=False)
    if ckpt["arch"] != "volo_h12_l18" or ckpt["stage_info"]["l"] != 18 or \
            not all(torch.isfinite(v).all() for v in ckpt["state_dict"].values()):
        fail("last.ckpt does not hold a finite volo_h12_l18")
    return k1, k2


def _reset_mhsa_counts():
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    for k in A.LAUNCHES:
        A.LAUNCHES[k] = 0
    for k in V.LAUNCHES:
        V.LAUNCHES[k] = 0
    X.LAUNCHES.clear()


def phase_deit(torch, card, steps: int = 4, batch: int = 64):
    """deit_small through the fixed trainer at full width, then two steps of
    the distilled variant, then the step time on a device-resident batch."""
    import argparse
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops.attention import LAUNCHES
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    os.environ.pop("AUTOPROG_FUSED_ATTN", None)
    total = {"fwd": 0, "bwd": 0}
    for model, n_steps, tokens in (("deit_small_patch16_224", steps, 197),
                                   ("deit_small_distilled_patch16_224", 2, 198)):
        out = tempfile.mkdtemp(prefix="chip_smoke_deit_")
        argv = ["synthetic://", "--model", model, "--img-size", "224", "-b", str(batch),
                "--model-ema", "--model-ema-decay", "0.999", "--drop-path", "0.1",
                "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr",
                "1e-3", "--fake-data-size", str(n_steps * batch), "--workers", "6",
                "--log-interval", "1", "--output", out]
        _reset_mhsa_counts()
        t0 = time.time()
        best = main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        run = glob.glob(os.path.join(out, "train", "*"))[0]
        log = open(os.path.join(run, "log.txt")).read()
        losses = [float(v) for v in re.findall(r"Train: 0 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
        say(f"phase 6 deit: python -m autoprog_tpu_torch.main {' '.join(argv[:-2])} "
            f"({wall:.1f} s incl. data and eval)")
        say(f"phase 6 {model} ({tokens} tokens, head_dim 64) losses: {losses}")
        if len(losses) != n_steps or not all(math.isfinite(v) for v in losses):
            fail(f"expected {n_steps} finite losses, got {losses}")
        say(f"phase 6 launches: K1 {launches} (train steps {n_steps} x 12 layers = "
            f"{12 * n_steps})")
        if launches["bwd"] != 12 * n_steps or launches["fwd"] < 12 * n_steps:
            fail(f"K1 launches {launches} do not cover 12 layers x {n_steps} steps")
        tests = [ln for ln in log.splitlines() if re.search(r"Test(_EMA_\S+)?: loss", ln)]
        for ln in tests:
            say("phase 6 eval: " + ln.split("autoprog_tpu_torch: ")[-1])
        if len(tests) != 2 or best is None:
            fail("the eval pass did not print a top-1 line for the model and its EMA")
        for k in total:
            total[k] += launches[k]

    # the step alone: soft-target CE, AdamW, one EMA, drop-path 0.1
    args = argparse.Namespace(opt="adamw", opt_betas=None, opt_eps=None, weight_decay=0.05,
                              token_label=False, token_label_size=1, ground_truth=False,
                              dense_weight=0.5, cls_weight=1.0)
    torch.manual_seed(0)
    model = create_model("deit_small_patch16_224").make(
        num_classes=1000, drop_path_rate=0.1, dtype=torch.bfloat16).cuda()
    state = TrainState.create(model=model, optimizer=create_optimizer(args, model),
                              ema_decays=(0.999,))
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=(0.999,), num_classes=1000,
                     device=torch.device("cuda"), seed=0)
    g = torch.Generator("cuda").manual_seed(6)
    data = {"image": torch.randn(batch, 224, 224, 3, device="cuda", generator=g),
            "label": torch.randint(0, 1000, (batch,), device="cuda", generator=g)}
    ms = {}
    for value in ("0", "1", "1", "0"):
        os.environ["AUTOPROG_FUSED_ATTN"] = value
        ms.setdefault(value, []).append(_time_cuda(
            torch, lambda: sb.train_step(state, data, 1e-3, r=224), 10))
    del os.environ["AUTOPROG_FUSED_ATTN"]
    on, off = sum(ms["1"]) / 2, sum(ms["0"]) / 2
    say(f"phase 6 deit_small train step b={batch} 224px bf16 on {card}: K1 on {on:.2f} ms "
        f"({batch / on * 1e3:.1f} img/s; runs {ms['1']}), AUTOPROG_FUSED_ATTN=0 {off:.2f} ms "
        f"({batch / off * 1e3:.1f} img/s; runs {ms['0']})")
    return total


def phase_measure(torch):
    """The measurement entry points, as a user calls them: the two attention
    benches at B = 128 (their tables go to stdout) and the headline bench
    (its one JSON line is parsed, then printed). Returns the launch counts
    of K5 and of every variant over this phase."""
    import contextlib
    import io
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn, bench_attn_x as X
    os.environ.pop("AUTOPROG_FUSED_ATTN", None)
    os.environ.pop("AUTOPROG_FUSED_OUTLOOK", None)
    _reset_mhsa_counts()
    say("phase 7 python -m autoprog_tpu_torch.scripts.bench_attn 128")
    bench_attn.main(["128"])
    say("phase 7 python -m autoprog_tpu_torch.scripts.bench_attn_x 128")
    X.main(["128"])
    counts = {"mhsa_fwd": A.LAUNCHES["fused_fwd"], "mhsa_bwd": A.LAUNCHES["fused_bwd"],
              **V.LAUNCHES, **X.LAUNCHES}
    say(f"phase 7 launches by the two benches: {counts}")
    want = ["mhsa_fwd", "mhsa_bwd", *V._KERNELS] + [
        X.variant_name(o, G) + side for o, G in GROUPS for side in ("_fwd", "_bwd")]
    missing = [k for k in want if counts.get(k, 0) <= 0]
    if missing:
        fail(f"the benches did not launch {missing}")
    say("phase 7 python -m autoprog_tpu_torch.bench")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        bench.main()
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1:
        fail(f"bench.main printed {len(lines)} lines on stdout, not one")
    result = json.loads(lines[0])
    say(f"phase 7 bench ({time.time() - t0:.1f} s): {lines[0]}")
    if list(result) != ["metric", "value", "unit", "vs_baseline"] or \
            result["metric"] != "volo_d1_train_imgs_per_sec_per_chip" or \
            not (result["value"] > 0 and result["vs_baseline"] > 0):
        fail(f"bench.main's line does not hold the four keys with positive values: {result}")
    return counts


def _time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call between two CUDA events, after a warm-up."""
    from autoprog_tpu_torch.scripts.timing import time_call
    return time_call(fn, iters, warmup)


def phase_kernel_times(torch, card):
    """K1 at the volo_d1 shape, with `F.scaled_dot_product_attention` (one
    PyTorch call for the same function, used nowhere in the port) beside it."""
    import torch.nn.functional as F
    from autoprog_tpu_torch.ops import attention as A
    B, n, H, d = 128, 196, 12, 32
    gen = torch.Generator("cuda").manual_seed(1)
    qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
    scale = d ** -0.5

    def sdpa(x):
        q, k, v = x.view(B, n, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return o.permute(0, 2, 1, 3).reshape(B, n, H * d)

    leaf = qkv.clone().requires_grad_(True)
    lib_out = sdpa(leaf)
    t = {
        "fwd": _time_cuda(torch, lambda: A._launch_fwd(qkv, H, scale, False), 50),
        "plain_fwd": _time_cuda(torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale), 20),
        "bwd": _time_cuda(torch, lambda: A._launch_bwd(qkv, dout, H, scale, False), 50),
        "plain_bwd": _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale), 20),
        "lib_fwd": _time_cuda(torch, lambda: sdpa(qkv), 50),
        "lib_bwd": _time_cuda(torch, lambda: torch.autograd.grad(
            lib_out, leaf, dout, retain_graph=True), 50),
    }
    # least time: 2 n^2 d FLOP per product and head (2 products forward, 5
    # backward with the recomputed scores) at the bf16 peak, against qkv and
    # out (forward) or qkv, dout and dqkv (backward) moved once
    C, item = H * d, 2
    prod = 2 * n * n * d * H * B
    t["bound_fwd"], t["by_fwd"] = _bound(4 * B * n * C * item, 2 * prod, BF16_FLOPS)
    t["bound_bwd"], t["by_bwd"] = _bound(7 * B * n * C * item, 5 * prod, BF16_FLOPS)
    say(f"phase 8 K1 [B={B}, n={n}, C={C}, heads={H}] bf16 on {card}: "
        f"fwd {t['fwd']:.4f} ms (plain {t['plain_fwd']:.4f}, SDPA {t['lib_fwd']:.4f}, bound "
        f"{t['bound_fwd']:.4f} by {t['by_fwd']}), bwd {t['bwd']:.4f} ms (plain "
        f"{t['plain_bwd']:.4f}, SDPA backward {t['lib_bwd']:.4f}, bound {t['bound_bwd']:.4f} "
        f"by {t['by_bwd']})")
    return t


def phase_mhsa_variant_times(torch, card, t_k1):
    """K5 and every variant at the volo_d1 shape beside its twin and SDPA
    (K1's library yardstick, timed in phase_kernel_times). Returns
    {row: {ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    B, n, H, d = 128, 196, 12, 32
    gen = torch.Generator("cuda").manual_seed(7)
    qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
    q, k, v = (torch.randn(B, n, H, d, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    g4 = dout.view(B, n, H, d)
    scale = d ** -0.5
    # the variants' twins are K1's at the variant's score type
    plain = {
        ("fwd", True): _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale, True), 20),
        ("bwd", True): _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale, True), 20),
        ("fwd", False): t_k1["plain_fwd"],
    }
    rows = {
        "mhsa_fwd": (_time_cuda(torch, lambda: A._launch_fused_fwd(q, k, v, scale), 50),
                     _time_cuda(torch, lambda: A.mhsa_fused_reference(q, k, v, scale), 20),
                     "fwd"),
        "mhsa_bwd": (_time_cuda(torch, lambda: A._launch_fused_bwd(q, k, v, g4, scale), 50),
                     _time_cuda(torch, lambda: A.mhsa_fused_backward_reference(
                         q, k, v, g4, scale), 20), "bwd"),
    }
    for name in V._KERNELS:
        rows[name] = (_time_cuda(torch, lambda: V._launch(name, qkv, H, scale), 50),
                      plain[("fwd", V.SCORES_F32[name])], "fwd")
    for order, G in GROUPS:
        key = X.variant_name(order, G)
        rows[key + "_fwd"] = (_time_cuda(
            torch, lambda: X._launch_group_fwd(order, G, qkv, H, scale), 50),
            plain[("fwd", True)], "fwd")
        rows[key + "_bwd"] = (_time_cuda(
            torch, lambda: X._launch_group_bwd(order, G, qkv, dout, H, scale), 30),
            plain[("bwd", True)], "bwd")
    # the same bytes and products as K1: q, k, v and out (forward), or q, k,
    # v, dout and three gradients (backward), moved once
    out = {}
    for key, (ms, plain_ms, side) in rows.items():
        out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": t_k1["lib_" + side],
                    "bound_ms": t_k1["bound_" + side], "bound_by": t_k1["by_" + side]}
        say(f"phase 8 {key} [B={B}, n={n}, C={H * d}, heads={H}] bf16 on {card}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, SDPA {t_k1['lib_' + side]:.4f}, bound "
            f"{t_k1['bound_' + side]:.4f} by {t_k1['by_' + side]}; K1 {t_k1[side]:.4f})")
    return out


def _bound(nbytes: float, flops: float, peak: float):
    """(least ms, what sets it): bytes over the HBM rate against operations
    over the peak of their type."""
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_outlook_times(torch, card):
    """One outlooker layer's op at the volo_d1 shape through the unfused
    path, K2, K3 and K4 (forward, and forward + backward through autograd),
    then each kernel alone beside its plain twin. The K3 / K4 launch counts
    of the report are read over this phase's variants run."""
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.ops.outlook import outlook_attention
    B, H, C, heads = 128, 28, 192, 6
    d, n = C // heads, (H // 2) ** 2
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(4)
    v = torch.randn(B, H, H, C, device="cuda", generator=gen).bfloat16()
    logits = (2 * torch.randn(B, H // 2, H // 2, heads * 81, device="cuda",
                              generator=gen)).bfloat16()
    gout = torch.randn(B, H, H, C, device="cuda", generator=gen).bfloat16()
    ops = {
        "unfused": lambda a, b: outlook_attention(a, b, num_heads=heads, kernel_size=3,
                                                  stride=2, padding=1, scale=scale),
        "K2": lambda a, b: O.outlook_attention_fused(a, b, heads, scale),
        "K3": lambda a, b: O.outlook_attention_hybrid(a, b, heads, scale),
        "K4": lambda a, b: O.outlook_attention_hybrid2(a, b, heads, scale),
    }
    for k in O.LAUNCHES:
        O.LAUNCHES[k] = 0
    vr, lr = v.clone().requires_grad_(True), logits.clone().requires_grad_(True)

    def fwd_bwd(op):
        vr.grad = lr.grad = None
        op(vr, lr).backward(gout)

    res = {}
    for name, op in ops.items():
        with torch.no_grad():
            f = _time_cuda(torch, lambda: op(v, logits), 20)
        fb = _time_cuda(torch, lambda: fwd_bwd(op), 20)
        res[name] = (f, fb)
        say(f"phase 8 outlook op [B={B}, {H}x{H}, C={C}, heads={heads}] bf16 on {card}: "
            f"{name} forward {f:.4f} ms, forward + backward {fb:.4f} ms")
    variants = dict(O.LAUNCHES)
    say(f"phase 8 variants run launches: {variants}")
    if not all(variants[k] > 0 for k in ("fwd", "bwd", "attend_hm", "attend")):
        fail(f"the variants run did not go through every outlook kernel: {variants}")

    patches = torch.randn(B, n, 9, C, device="cuda", generator=gen).bfloat16()
    att = (2 * torch.randn(B, n, 9, 9, heads, device="cuda", generator=gen)).bfloat16()
    t = {
        "fwd": _time_cuda(torch, lambda: O._launch_fwd(v, logits, heads, scale), 50),
        "plain_fwd": _time_cuda(
            torch, lambda: O.outlook_attention_fused_reference(v, logits, heads, scale), 10),
        "bwd": _time_cuda(torch, lambda: O._launch_bwd(v, logits, gout, heads, scale), 50),
        "plain_bwd": _time_cuda(torch, lambda: O.outlook_attention_backward_reference(
            v, logits, gout, heads, scale), 10),
    }
    for key, hm in (("attend_hm", True), ("attend", False)):
        t[key] = _time_cuda(torch, lambda: O._launch_attend(patches, att, heads, scale, hm), 50)
        t["plain_" + key] = _time_cuda(
            torch, lambda: O.outlook_attend_reference(patches, att, heads, scale, hm), 5)
    # bytes: every input read once, every output written once; operations:
    # 81 multiply-adds per window, head and channel of the head, in f32
    item = 2
    map_b, log_b, patch_b = B * H * H * C * item, B * n * heads * 81 * item, B * n * 9 * C * item
    attend_flops = 2 * B * n * 81 * C
    t["bound_fwd"], t["by_fwd"] = _bound(2 * map_b + log_b, attend_flops, F32_FLOPS)
    t["bound_bwd"], t["by_bwd"] = _bound(3 * map_b + 2 * log_b, 2 * attend_flops, F32_FLOPS)
    for key in ("attend_hm", "attend"):
        t["bound_" + key], t["by_" + key] = _bound(2 * patch_b + log_b, attend_flops,
                                                   F32_FLOPS)
    say(f"phase 8 K2 alone on {card}: fwd {t['fwd']:.4f} ms (plain {t['plain_fwd']:.4f}, "
        f"bound {t['bound_fwd']:.4f} by {t['by_fwd']}), bwd {t['bwd']:.4f} ms (plain "
        f"{t['plain_bwd']:.4f}, bound {t['bound_bwd']:.4f} by {t['by_bwd']}); attend K3 "
        f"{t['attend_hm']:.4f} ms (plain {t['plain_attend_hm']:.4f}), K4 {t['attend']:.4f} ms "
        f"(plain {t['plain_attend']:.4f}, bound {t['bound_attend']:.4f} by {t['by_attend']})")
    return t, variants


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

    def run(var: str, value: str) -> float:
        os.environ[var] = value
        for _ in range(3):
            sb.train_step(state, data, 1e-3, r=224)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = sb.train_step(state, data, 1e-3, r=224)["loss"]
        torch.cuda.synchronize()
        if not math.isfinite(float(loss)):
            fail(f"non-finite loss in the timed steps ({var}={value})")
        return (time.perf_counter() - t0) / iters * 1e3

    def compare(var: str, note: str):
        torch.cuda.reset_peak_memory_stats()
        ms, peak = {"0": [], "1": []}, {}
        for value in ("0", "1", "1", "0"):
            ms[value].append(run(var, value))
            peak[value] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
        on, off = sum(ms["1"]) / 2, sum(ms["0"]) / 2
        say(f"phase 8 volo_d1 train step b={batch} 224px bf16 on {card}, {note}: "
            f"{var}=1 {on:.2f} ms ({batch / on * 1e3:.1f} img/s; runs {ms['1']}; peak "
            f"{peak['1']:.2f} GiB), =0 {off:.2f} ms ({batch / off * 1e3:.1f} img/s; runs "
            f"{ms['0']}; peak {peak['0']:.2f} GiB)")
        return ms

    os.environ["AUTOPROG_FUSED_OUTLOOK"] = "0"
    compare("AUTOPROG_FUSED_ATTN", "unfused outlook")
    os.environ["AUTOPROG_FUSED_ATTN"] = "1"
    ms = compare("AUTOPROG_FUSED_OUTLOOK", "K1 on")
    del os.environ["AUTOPROG_FUSED_OUTLOOK"]
    # runs in the order 0, 1, 1, 0: each =1 run beside the =0 run next to it
    gains = [1.0 - on / off for on, off in zip(ms["1"], ms["0"])]
    verdict = "both" if min(gains) >= 0.02 else "not both"
    say(f"phase 8 K2 in the step: {['%.1f %%' % (100 * g) for g in gains]} faster than the "
        f"unfused outlook path in the two repetitions ({verdict} at least 2 %)")


def _row(name, src, replaces, launches, err, t, key):
    lib = t.get("lib_" + key)
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t[key],
            "plain_ms": t["plain_" + key], "bound_ms": t["bound_" + key],
            "bound_by": t["by_" + key], "library_ms": lib}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    try:
        import autoprog_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository: {e}")
    t_start = time.time()
    name, card = phase_device(torch)
    phase_build()
    worst = phase_kernels(torch)
    worst_v = phase_mhsa_variants(torch)
    worst_o = phase_outlook_kernels(torch)
    phase_model_parity(torch)
    phase_outlook_model_parity(torch)
    fixed, fixed_k2 = phase_trainer(torch)
    prog_k1, prog_k2 = phase_prog_trainer(torch)
    deit_k1 = phase_deit(torch, card)
    measured = phase_measure(torch)
    t = phase_kernel_times(torch, card)
    tv = phase_mhsa_variant_times(torch, card, t)
    to, variants = phase_outlook_times(torch, card)
    phase_step_times(torch, card)
    pal = "autoprog_tpu/ops/outlook_pallas.py"
    att = "autoprog_tpu/ops/attention_pallas.py"
    k1 = {side: fixed[side] + prog_k1[side] + deit_k1[side] for side in ("fwd", "bwd")}

    def vrow(key, src, replaces):
        return {"name": key, "route": "cuda", "source": src, "replaces": replaces,
                "launches": measured[key], "max_abs_err": worst_v[key], **tv[key]}

    report = {"kernels": [
        _row("mhsa_qkv_fwd", MHSA_SRC, att + ":206", k1["fwd"], worst["fwd"], t, "fwd"),
        _row("mhsa_qkv_bwd", MHSA_SRC, att + ":228", k1["bwd"], worst["bwd"], t, "bwd"),
        _row("outlook_fused_fwd", OUTLOOK_SRC, pal + ":80", fixed_k2["fwd"] + prog_k2["fwd"],
             worst_o["fwd"], to, "fwd"),
        _row("outlook_fused_bwd", OUTLOOK_SRC, pal + ":203", fixed_k2["bwd"] + prog_k2["bwd"],
             worst_o["bwd"], to, "bwd"),
        _row("outlook_attend_hm", OUTLOOK_SRC, pal + ":237", variants["attend_hm"],
             worst_o["attend_hm"], to, "attend_hm"),
        _row("outlook_attend", OUTLOOK_SRC, pal + ":326", variants["attend"],
             worst_o["attend"], to, "attend"),
        vrow("mhsa_fwd", MHSA_SRC, att + ":47"),
        vrow("mhsa_bwd", MHSA_SRC, att + ":67"),
        vrow("twophase", VARIANTS_SRC, "scripts/attn_variants.py:64"),
        vrow("twophase_bf16s", VARIANTS_SRC, "scripts/attn_variants.py:64"),
        vrow("pipelined", VARIANTS_SRC, "scripts/attn_variants.py:73"),
    ] + [vrow(f"{order}_img{G}_{side}", VARIANTS_SRC, "scripts/bench_attn_x.py:" + line)
         for order, G in GROUPS
         for side, line in (("fwd", "47" if order == "phase" else "69"), ("bwd", "86"))]}
    say(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s on {card}")
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
