#!/usr/bin/env python3
"""Smoke run of the PyTorch port (autoprog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

(K1, K5 and the MHSA variants against an earlier commit's, in turns on the
same card: `python -m autoprog_tpu_torch.scripts.mhsa_turns --parent DIR`.)

Phases (each prints its lines; any failure exits non-zero; nothing falls
back to the CPU or to a plain twin):
  1. device: name, nvidia-smi name and power limit, TF32 flags (set off);
  2. build: nvcc builds the CUDA kernels from csrc/ (build/kernels/), one
     compiler process per source, all at once; prints the registers and the
     spill bytes `ptxas -v` reports for every K1 / K5 kernel, for the MHSA
     variants' resident kernels (`fwd_walk`, `fwd_park`, `fwd_phase`,
     `bwd_walk`) and for K2's row kernels (`outlook_fwd_rows`,
     `outlook_bwd_rows`, bf16 and f32) and fails if one of K1's
     resident-path kernels (`mhsa_fwd_res`, `mhsa_bwd_res`) or of K2's row
     kernels spills;
  3. kernel vs plain, on the card, bf16 and f32, tolerance 2 ulp of the
     largest value: K1 forward and backward at the volo_d1 shapes (B=32,
     C=384, 12 heads, n = 64/100/144/196), at the DeiT shapes (n = 197 and
     198, head_dim 64), at a rank's heads under `--model-parallel 2` (phase
     12's [64, 196, 6, 32] and [8, 196, 8, 48]), at the router's edge
     (n=1024, head_dim 128), with
     f32 scores, on both sides of the resident path's limit (n = 256, 257),
     at n = 1, 15, 16, 17 and at a head_dim that is no multiple of 16; the
     forward returns the row statistics, which are held against the twin's
     and fed to the backward, and without them both give the same bits; K5
     (separate q, k, v; contiguous and as views of one
     buffer) at the same shapes; every schedule variant (twophase,
     twophase_bf16s, pipelined) and every G-images-per-block variant (order
     phase or loop, G = 1, 2, 4; forward and backward) against its twin and
     K1's launch at the same score type (2 ulp) and, bit for bit, against K1
     at that score type at [128, 196, 12, 32] (the benches' shape: more
     items than resident blocks), [32, 196, 12, 32] and [8, 197, 6, 64] (the
     resident kernels) and against `loop_img1` at [8, 257, 4, 32] (the
     streaming ones), each call's kernels, as the library counts them beside
     each launch, the ones its shape routes to, and the most images a block
     of order phase takes at five resident shapes; K2 forward and
     backward at B=32, C=192, 6 heads, H=W=16/20/24/28, at a rank's heads
     under `--model-parallel 2` (phase 12's v [64, 28, 28, 96] on 3 heads
     and [8, 28, 28, 192] on 6; every row plan's head group divides its
     heads), at the d2 and d4 widths, at an odd shape (H=10, W=6, head_dim 48), with several runs of
     rows per image, with more items than blocks, on one window, and through
     the general kernels (head_dim 20 in bf16, head_dim 3, and forced at the
     volo_d1 map), each launched twice for the same bits, each on the route
     its shape asks for; K3 and K4 at n=196. Then the volo_d1 f32 forward through
     K1 against the unfused MHSA, and with AUTOPROG_FUSED_OUTLOOK=1 against
     =0 (1e-3);
  4. fixed trainer: `autoprog_tpu_torch.main.main` on synthetic:// with
     volo_d1 at 224 px, batch 64, token labels, MixToken, drop-path 0.1 and 4
     EMA decays, on the port's defaults (K1 and K2 on), 4 train steps and one
     eval pass; checks finite losses, the launch counts of K1 (14 per step)
     and K2 (4 per step, every one through K2's row kernels), the EMA trees
     and the eval line;
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
     checks value > 0, vs_baseline > 0, that K5 and every variant were
     launched, each variant through its resident kernels, and that
     `bench_attn_x`'s own check found every variant bit for bit equal to K1
     at f32 scores, forward and backward;
  8. times (CUDA events / synchronised clock, after warm-up, bf16), on the
     card named beside them: K1 at [128, 196, 384, 12 heads] with
     `F.scaled_dot_product_attention` as its library yardstick;
     `scripts.bench_k1`'s table, K1 at both score types beside `loop_img1`
     (S1 at G = 1, f32 scores), with SDPA timed in the same turns, at the
     four stage shapes n = 64, 100, 144, 196 and at DeiT's [64, 197, 384, 6
     heads]; K5 and every variant at [128, 196, 384, 12 heads], each beside
     its twin, K1 at its score type, SDPA and the bound; one
     outlooker layer's op at [128, 28, 28, 192] through the unfused path, K2,
     K3 and K4, forward and forward + backward; `scripts.bench_k2`'s table,
     K2 at the four stage maps and the d4 width beside its general kernels
     and the unfused op; the attend kernel alone;
     and the full volo_d1 train step at batch 128, 224 px, K1 on against
     AUTOPROG_FUSED_ATTN=0 and then AUTOPROG_FUSED_OUTLOOK 0, 1, 1, 0, with
     peak memory;
  9. the checkpoint path on phase 4's and phase 5's files: `validate.main`
     on phase 4's model_best.ckpt (plain and `--use-ema --ema-idx 3`, the
     trainer's 64 eval samples in one batch) must give the trainer's
     summary row exactly, launching K1 14 and K2's row kernels 4 times;
     `main.main --resume last.ckpt` for one more epoch (the state before the
     first resumed step equal to the file's bit for bit: parameters, 4 EMA
     trees, Adam moments, step; 4 finite losses; K1 / K2 backward 14 / 4 a
     step); `main_prog.main --resume checkpoint-2.ckpt` (after the growth to
     r=224, l=18: the stage and arch rebuilt from the record, the same bit
     check, the step restarting at the stage as in the JAX package: 5 -> 10);
     `--finetune` into 100 classes for 2 steps (heads re-initialised, every
     other parameter the file's); then the volo_d1 eval forward at b=128,
     224 px, bf16 with K1 + K2 on against both off (on, off, off, on);
  (phase 4 also requires that no gradient was filled with zeros: every
     parameter of a full-depth step has one; phase 5 prints the fills the
     supernet's keep masks cause)
 10. the train step's options at volo_d1's full width: `main.main` for 3
     steps at b=64 with `--uint8-pipe --reprob 0.25 --model-ema-bf16
     --adam-mu-bf16` and AUTOPROG_SPARSE_TL=1 (every step launches K1 / K2
     once a layer, forward and backward, and moves every bf16 EMA tree;
     exp_avg is bf16); one step at b=64, drop-path 0.1, under `--remat`
     "", "full" and "dots" (loss and every gradient equal to the plain
     step's within 2 ulp of bf16, or bit for bit, as printed; K1 / K2
     forwards twice a layer under remat) and the step's time and peak memory
     at b=128 in each mode and at b=256 with "full"; the sparse token-label
     target against the dense one at b=128, r=224 and r=128 (loss and the
     outputs' gradients within 1e-4 relative); `bench.py`'s step with each
     of its three knobs against none (before and after); 4 steps of `--opt
     sgd` under `--profile` (a trace naming K1's and K2's kernels); and
     `scripts.bench_parts` at b=128 (with `--loss-bisect`) and b=256;
 11. data parallelism (`parallel/mesh.py`): (a) world 1 on NCCL, torchrun's
     environment set by hand in this process: `main.main` with phase 4's
     arguments (finite losses printed beside phase 4's, K1 14 and K2 4
     launches a step forward and backward, the gradient all-reduce once a
     step); (b) two gloo ranks sharing cuda:0, this script run as
     `--dist-worker DIR` twice: `main_prog.main` with phase 5's arguments at
     global b=64 and `--model-ema-bf16` (one decision, rank 0's, adopted by
     both; one stage history ending at r=224, l=18; parameters, BatchNorm
     stats and the bf16 EMA trees bit-equal across the ranks; K1 and K2
     launched on each rank; 20 gradient all-reduces; checkpoints from rank 0
     alone); (c) one volo_d1
     f32 step on 32 images over the two ranks against this process's step
     on the same images and parameters (loss within 1e-4 relative; the
     all-reduced gradients within 1e-4 relative in the 2-norm over all of
     them and per tensor, the stem's tensors within 5e-3: cancellation in
     BatchNorm's backward leaves their gradients less exact; the limits sit
     between the clean and the planted-fault readings of
     `autoprog_tpu_torch/scripts/dp_parity.py`; every BatchNorm stat
     within |err| <= 1e-4 (|x| + max |x|)); (d) the b=128 bf16 step without a group, under
     NCCL world 1 and without again, the gradient all-reduce alone, and the
     2-rank gloo step's time, which is two ranks sharing one card through
     the host, not a data-parallel speed;
 12. tensor parallelism (`--model-parallel 2`, `parallel/tp.py`), two gloo
     ranks of one model group sharing cuda:0 (this script run as
     `--tp-worker DIR ROLE`), two such worlds side by side, one taking (a),
     (b) and (d), the other (c) and (e), against this process on the same
     card:
     (a) the volo_d1 f32 step on 32 images (biases drawn from N(0, 0.02))
     against one process's, clean and with `scripts/tp_parity.py`'s two
     planted faults (the row-parallel reduce skipped, the bias added on every
     rank): the clean step within that script's limits, each fault beyond
     them; (b) 4 bf16 steps at b=64 with K1 and K2 on (each rank launches K1
     on 6 heads and K2's row kernels on 3, once a layer, as K1's launches by
     shape and K2's plans record them), then 4 with both
     off (no launch); the eval logits of 8 images at f32 through K1 + K2
     against the unfused M = 2 path and against one process (1e-3), and at
     bf16 against one process within 3 times the one-process bf16 logits'
     distance from the f32 ones (each row-parallel output rounds its partial
     products once more than the one-device layer, an error of the size
     bf16 already makes); the per-step times, which are gloo through the
     host on one card, not a tensor-parallel speed; (c) `main_prog
     --auto-grow --model-parallel 2` with phase 5's arguments, cut to a
     global batch of 16, 2 steps an epoch and 1 probe batch and 1 timed
     step a candidate (`TP_PROG_CUTS`; the widths, epochs and stages are
     phase 5's):
     one decision,
     the replicated leaves bit-equal across the ranks, checkpoints from rank
     0 alone with the keys and shapes of phase 5's, and its checkpoint-2.ckpt
     resumed at M = 2 and at M = 1 (the state before the first step equal to
     the file's bit for bit, the last step the unbroken run's); (d) volo_d4 (768 wide, 16
     heads) at 224 px: one f32 step at global batch 8 against one process
     within tp_parity's limits and one bf16 step that runs K1 at head_dim
     48 in its 28 transformer layers; (e) `validate.py` over the two ranks
     on 70 images at -b 16 against one process: top-1 and top-5 equal, the
     loss within 1e-5; (f) the step's options on volo_d4's widths (768, 16
     heads; `volod4_h16_l4`, its depth cut to 2 outlookers and 2
     transformers) at 224 px and global batch 8, two composite legs of 2
     f32 steps against one process: leg A `--opt sgd`, `--batch-splits 2`,
     `--remat dots`, drop-path 0.1 and sparse token labels, leg B AdamW
     (eps 1e-3) with `--adam-mu-bf16` and `--model-ema-bf16`; each step's
     loss and gradients within tp_parity's limits, the parameters within
     1e-6 (leg B's after step 2, its bf16 moments and EMA trees within the
     bounds of `tp_parity.mu_bf16_bounds` and one bf16 step), then one bf16
     step of each leg (finite); K1 launched on 8 local heads at head_dim 48
     and K2 on its row kernels, counted on the main path;
 13. the measurement scripts (`autoprog_tpu_torch/scripts/`), each run as a
     user runs it, in a process of its own, its last stdout line parsed:
     `bench_roofline 128` (every row and segment counts FLOP and bytes, none
     sits above 100 % of its floor, the counted full step launched K1 and
     K2), `bench_eval 128`, `bench_remat --iters 3`, `bench_family --iters 3`
     (volo_d4 b=32 and volo_d5 b=8 under remat), `bench_outlook 128
     --blockdiag --fused` (each fused row launched its kernel and K2's
     backward) and `bench_loader --images 512 --repeats 1` on the host's
     cores (at most 8) in its three modes, with the native decoder loaded;
     any nonzero exit fails the run.
 14. the A/B and accuracy scripts (`autoprog_tpu_torch/scripts/`), each run
     as a user runs it, in a process of its own, at a cut:
     `analyze_rehearsal` over phase 5's and phase 4's logs (phase 5's
     decision, its stages ending at r=224, l=18, both runs' total train
     time); `real_data_digits --epochs 2 --seeds 42` (both arms a finite
     top-1, the AutoProg arm a decision); `ab_procgen --epochs 2
     --train-size 512 --num-classes 10 --img-size 64 -b 32 --stages 2
     --seeds 42 --workers 4`, then `--summarize-only`, which must reuse the
     pair and print its table again; `ab_search_sync --fake-data-size 512
     --search-probe-steps 10` (both timed legs print a per-probe time; it
     runs beside the two accuracy scripts, so its times are no measurement). Each
     trainer run's K1 / K2 launches are read from its log's last line and
     must be above 0. The bench scripts `ab_bf16_state` and `ab_sparse_tl`
     are left out: phase 10 already sets their switches on the card. Any
     nonzero exit, 4 included, fails the run.
 15. LayerNorm (run right after phase 3; `ops/layernorm.py`,
     `csrc/layernorm.cu`): the kernels against the plain twin on the card
     (F.layer_norm in f32 between the widen and the cast), y, dx, dgamma and
     dbeta, bf16 and f32, at every [rows, C] the benchmark's cells run
     ([50432, 384], [100352, 192], [25088, 384], [25216, 384], [128, 384]),
     a ragged row count and C = 32, 768, 1024: y and dx within 1 ulp of bf16
     (f32: 1e-5 of the largest value), dgamma and dbeta within 1e-5 of the
     largest value (`_ln_gap` gives the reasons); each call twice, the same
     bits; one forward and two backward launches a call; one deit_small step
     at b=16 under `--remat full` against the plain step (2 ulp of bf16, 25
     / 49 forward launches); times at [50432, 384] and [100352, 192] beside
     the plain chain, one F.layer_norm on bf16 and the bound; the host's time
     a call, forward and forward + backward, against the plain chain at
     [128, 384] (median of 60 alternating blocks).
     Phases 4 and 6 also check 82 and 50 LayerNorm backward launches a step
     (41 and 25 LayerNorms).

The line before the last is the kernel report (JSON): for each kernel its
launches on its path (K1 and K2: phases 4 to 6 and 9 to 12, both ranks of
phase 11 (b) and of phase 12 (c) and (f) counted, and apart from them, under
`script_launches`, phase 13's and phase 14's scripts by name; K1's rows per shape: phases
4 to 7 at that shape; `loop_img1`: its timing run of phase 8; K3, K4: the
variants run of phase 8 and phase 13's outlook rows; K5 and the MHSA
variants: the measurement scripts of phase 7), its
worst error against the twin, its time, the twin's,
the least time the card could take (`bound_ms`, from the bytes it must move
at 3.35 TB/s and its operations at the peak of their type), the library
call's time where one exists (LayerNorm's rows: each per shape, phase
15's; its launches those of phases 4 and 6); a variant's row names the kernels its phase 7
launches ran, as the library counted them (`kernel`). The last line is {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 before printing any result.
"""

import glob
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

TOL_ULPS = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -20}
MHSA_SRC = "autoprog_tpu_torch/csrc/mhsa_qkv.cu"
OUTLOOK_SRC = "autoprog_tpu_torch/csrc/outlook.cu"
VARIANTS_SRC = "autoprog_tpu_torch/csrc/mhsa_variants.cu"
LN_SRC = "autoprog_tpu_torch/csrc/layernorm.cu"
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


# the resident kernels of csrc/mhsa_variants.cu
VARIANT_KERNELS = ("fwd_walk", "fwd_park", "fwd_phase", "bwd_walk")


def phase_build():
    """Build the kernels, all compilers at once; print registers and spills."""
    from autoprog_tpu_torch import _build
    from autoprog_tpu_torch.scripts.mhsa_turns import short_kernel
    t0 = time.time()
    libs = _build.build()
    dt = time.time() - t0
    _build.load()
    entry = re.compile(r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, (\d+) bytes "
                       r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        regs = re.findall(r"Used (\d+) registers", log)
        say(f"phase 2 build: {lib.name} (registers per kernel: {regs})")
        if lib.name.startswith("mhsa_qkv") or lib.name.startswith("mhsa_variants"):
            for name, stack, st, ld, used in entry.findall(log):
                short = short_kernel(name)
                if lib.name.startswith("mhsa_variants") and \
                        not short.startswith(VARIANT_KERNELS):
                    continue  # the streaming kernels, unchanged
                say(f"phase 2 ptxas: {short}: {used} registers, {stack} bytes stack, spill "
                    f"stores {st} loads {ld} bytes")
                if "_res" in short and (int(st) or int(ld)):
                    fail(f"{short} spills registers ({st} / {ld} bytes)")
        elif lib.name.startswith("outlook"):
            # K2's row kernels, forward and backward, f32 and bf16
            for name, stack, st, ld, used in entry.findall(log):
                kernel = re.search(r"\d+(outlook_[a-z]+_rows)I(13__nv_bfloat16|f)E", name)
                if not kernel:
                    continue
                short = f"{kernel.group(1)}<{'float' if kernel.group(2) == 'f' else 'bf16'}>"
                say(f"phase 2 ptxas: {short}: {used} registers, {stack} bytes stack, spill "
                    f"stores {st} loads {ld} bytes")
                if int(st) or int(ld):
                    fail(f"{short} spills registers ({st} / {ld} bytes)")
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
    # the router's edge, the AUTOPROG_ATTN_SCORES_F32=1 variant, DeiT small,
    # plain and distilled (197 and 198 tokens, head_dim 64), a rank's heads
    # under --model-parallel 2 (phase 12: volo_d1's 6 of 12 at b=64, volo_d4's
    # 8 of 16 at head_dim 48); then both sides of the resident path's limit,
    # the smallest sequences and a head_dim that is no multiple of 16
    shapes = ([(32, n, 12, 32, False) for n in (64, 100, 144, 196)]
              + [(4, 1024, 3, 128, False), (32, 196, 12, 32, True),
                 (8, 197, 6, 64, False), (8, 198, 6, 64, False),
                 (64, 196, 6, 32, False), (8, 196, 8, 48, False)]
              + [(8, n, 4, 32, sf) for n in (256, 257) for sf in (False, True)]
              + [(8, 256, 2, 64, False), (8, 200, 2, 72, False)]
              + [(4, n, 2, 32, False) for n in (1, 15, 16, 17)]
              + [(4, 100, 3, 24, False), (4, 209, 3, 40, True)])
    gen = torch.Generator("cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for B, n, H, d, sf in shapes:
            qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).to(dt)
            dout = torch.randn(B, n, H * d, device="cuda", generator=gen).to(dt)
            scale = d ** -0.5
            out, stats = A._launch_fwd(qkv, H, scale, sf, want_stats=True)
            alone = A._launch_fwd(qkv, H, scale, sf)
            dq = A._launch_bwd(qkv, dout, H, scale, sf, stats)
            dq_alone = A._launch_bwd(qkv, dout, H, scale, sf)
            torch.cuda.synchronize()
            ref, ref_stats = A.mhsa_fused_qkv_reference(qkv, H, scale, sf, True)
            dref = A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale, sf, ref_stats)
            tag = f"{dt_name} B={B} n={n} heads={H} d={d} scores_f32={int(sf)}"
            for side, got, want in (("fwd", out, ref), ("bwd", dq, dref)):
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"K1 {side} {tag}: bad shape or non-finite")
                e, tol = _err(got, want), _tol(want, dt_name)
                say(f"phase 3 K1 {side} {tag}: max_abs_err {e:.3e} (tol {tol:.3e})")
                if not e <= tol:
                    fail(f"K1 {side} disagrees with its plain twin: {e} > {tol}")
                worst[side] = max(worst[side], e)
            # the statistics: the row maximum, and with it log-sum-exp = max +
            # log z (which does not depend on which of two near-equal scores
            # was the maximum), at the tolerance of the scores themselves
            lse, ref_lse = (t[..., 0] + t[..., 1].log() for t in (stats, ref_stats))
            if stats.shape != ref_stats.shape or \
                    not _err(stats[..., 0], ref_stats[..., 0]) <= _tol(ref_stats[..., 0], dt_name) \
                    or not _err(lse, ref_lse) <= _tol(ref_lse, dt_name):
                fail(f"K1 {tag}: the forward's row statistics disagree with the twin's "
                     f"(max {_err(stats[..., 0], ref_stats[..., 0]):.3e}, log-sum-exp "
                     f"{_err(lse, ref_lse):.3e})")
            if not (torch.equal(out, alone) and torch.equal(dq, dq_alone)):
                fail(f"K1 {tag}: results with and without the saved statistics differ")
    say("phase 3 K1: row maxima and log-sum-exp within the tolerance of the twin's, and the "
        "same bits with and without the saved statistics, at every shape")
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
    variant and every G-images-per-block variant (bf16) against its twin.
    Same tolerance and reason as K1's. K5 runs K1's kernels and must equal it
    bit for bit. The variants keep K1's arithmetic and its order: at the
    resident shapes (the benches' shape at B = 128 and 32, and DeiT's) they
    are built from K1's resident walks and must equal K1 at their score type
    bit for bit, forward and (S1) backward; at [8, 257, 4, 32] they run the
    streaming cells, K1's path there, and the f32 ones must equal
    `loop_img1`, which is that path. Each call must launch the kernels its
    shape routes to, as the library counts them."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    worst = {}
    gen = torch.Generator("cuda").manual_seed(5)
    shapes = [(32, n, 12, 32) for n in (64, 100, 144, 196)] + [
        (8, 197, 6, 64), (4, 1024, 3, 128), (8, 256, 4, 32), (8, 257, 4, 32), (4, 17, 2, 24)]
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
                out, stats = A._launch_fused_fwd(q, k, v, scale, want_stats=True)
                grads = A._launch_fused_bwd(q, k, v, g4, scale, stats)
                torch.cuda.synchronize()
                ref, ref_stats = A.mhsa_fused_reference(q, k, v, scale, True)
                _check(f"K5 fwd {how} {tag}", worst, "mhsa_fwd", out, ref, dt_name)
                _check(f"K5 fwd {how} vs K1 at f32 scores {tag}", worst, "mhsa_fwd", out, k1f,
                       dt_name)
                refs = A.mhsa_fused_backward_reference(q, k, v, g4, scale, ref_stats)
                for nm, got, want, k1 in zip(("dq", "dk", "dv"), grads, refs, k1b):
                    _check(f"K5 bwd {nm} {how} {tag}", worst, "mhsa_bwd", got, want, dt_name)
                    _check(f"K5 bwd {nm} {how} vs K1 {tag}", worst, "mhsa_bwd", got, k1,
                           dt_name)
                if not (torch.equal(out, k1f)
                        and all(torch.equal(a, b) for a, b in zip(grads, k1b))):
                    fail(f"K5 {how} {tag} {dt_name}: not K1's bits at f32 scores")
    say("phase 3 K5 equals K1 at f32 scores bit for bit at every shape, with and without the "
        "saved statistics")
    # the variants: the benches' shape at B = 128 (more items than resident
    # blocks, so a persistent block walks several: the next item in its
    # second buffer, the ring's slots reused) and at B = 32, DeiT's (odd n,
    # head_dim 64) on the resident path, n = 257 on the streaming one
    same, wrong = {}, []
    for B, n, H, d in [(128, 196, 12, 32), (32, 196, 12, 32), (8, 197, 6, 64), (8, 257, 4, 32)]:
        qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
        dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
        scale, tag = d ** -0.5, f"B={B} n={n} heads={H} d={d}"
        resident = n <= 256 and d <= 64
        V.RAN.clear()
        X.RAN.clear()
        k1f = {sf: A._launch_fwd(qkv, H, scale, sf) for sf in (False, True)}
        k1b = A._launch_bwd(qkv, dout, H, scale, True)
        loop1_f = X._launch_group_fwd("loop", 1, qkv, H, scale)
        loop1_b = X._launch_group_bwd("loop", 1, qkv, dout, H, scale)
        ref_name = "K1" if resident else "loop_img1"
        for name in V._KERNELS:
            sf = V.SCORES_F32[name]
            out = V._launch(name, qkv, H, scale)
            torch.cuda.synchronize()
            _check(f"S2 {name} {tag}", worst, name, out,
                   V.mhsa_fwd_variant_reference(name, qkv, H, scale), "bfloat16")
            _check(f"S2 {name} vs K1 scores_f32={int(sf)} {tag}", worst, name, out, k1f[sf],
                   "bfloat16")
            if resident or sf:
                same[f"{name} {tag}"] = torch.equal(out, k1f[sf] if resident else loop1_f)
        ref_f = X.group_reference(qkv, H, scale)
        ref_b = X.group_backward_reference(qkv, dout, H, scale)
        for order, G in GROUPS + [("loop", 1)]:
            key = X.variant_name(order, G)
            out = X._launch_group_fwd(order, G, qkv, H, scale)
            grad = X._launch_group_bwd(order, G, qkv, dout, H, scale)
            torch.cuda.synchronize()
            _check(f"S1 {key} fwd {tag}", worst, key + "_fwd", out, ref_f, "bfloat16")
            _check(f"S1 {key} fwd vs K1 at f32 scores {tag}", worst, key + "_fwd", out,
                   k1f[True], "bfloat16")
            _check(f"S1 {key} bwd {tag}", worst, key + "_bwd", grad, ref_b, "bfloat16")
            _check(f"S1 {key} bwd vs K1 at f32 scores {tag}", worst, key + "_bwd", grad, k1b,
                   "bfloat16")
            if resident or key != "loop_img1":
                same[f"{key} {tag}"] = torch.equal(out, k1f[True] if resident else loop1_f) \
                    and torch.equal(grad, k1b if resident else loop1_b)
        say(f"phase 3 variants at {tag} bit for bit equal to {ref_name} at their score type: "
            f"{ {k.split(' B=')[0]: v for k, v in same.items() if k.endswith(tag)} }")
        ran = {**V.RAN, **X.RAN}
        say(f"phase 3 kernels the variants launched at {tag}, as the library counted them: "
            f"{ {f'{key} {kernels}': c for (key, kernels), c in ran.items()} }")
        wrong += [f"{key} at {tag}: {kernels}" for key, kernels in ran
                  if kernels != V.expected_kernels(key, resident)]
        called = [*V._KERNELS] + [X.variant_name(o, G) + side for o, G in GROUPS + [("loop", 1)]
                                  for side in ("_fwd", "_bwd")]
        wrong += [f"{key} at {tag}: no launch counted" for key in called
                  if key not in {k for k, _ in ran}]
    if not all(same.values()):
        fail(f"a variant differs from K1 (resident shapes) or loop_img1 (n = 257): "
             f"{[k for k, v in same.items() if not v]}")
    if wrong:
        fail(f"a variant did not launch the kernels its shape routes to: {wrong}")
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
    # the most images a block takes in order phase (up to 64), by the
    # kernels' own refusal of the parked rows that do not fit
    fits = {}
    for n, d in ((64, 32), (196, 32), (256, 32), (197, 64), (256, 64)):
        for side in ("fwd", "bwd"):
            lo, hi = 0, 64
            while lo < hi:
                G = (lo + hi + 1) // 2
                x = torch.randn(G, n, 3 * d, device="cuda", generator=gen).bfloat16()
                try:
                    if side == "fwd":
                        X._launch_group_fwd("phase", G, x, 1, d ** -0.5)
                    else:
                        X._launch_group_bwd("phase", G, x, x[..., :d], 1, d ** -0.5)
                except ValueError:
                    hi = G - 1
                else:
                    lo = G
            fits[f"n={n} d={d} {side}"] = lo
    torch.cuda.synchronize()
    say(f"phase 3 the most images a block of order phase takes (of 64): {fits}")
    if min(fits.values()) < 4:
        fail("order phase does not take G = 4 at every resident shape")
    return worst


def phase_outlook_kernels(torch):
    """K2 forward and backward and the K3 / K4 attend against their plain
    twins; same tolerance and reason as K1's. K2 at the edges of its row
    kernels (the trainers' batches, several runs of rows per image, more
    items than resident blocks, the d2 / d4 widths, one window, H != W) and
    through its general kernels (head_dims whose channels are no whole
    16-byte group, and forced at the volo_d1 map); a second launch must give
    the same bits."""
    from autoprog_tpu_torch.ops import outlook_fused as O
    worst = {}
    # (B, H, W, C, heads, general): the four stage maps of volo_d1, the
    # volo_d1 map at phase 4's batch (two runs of 7 rows an image) and at the
    # bench's (one run of 14 rows), the d2 and d4 widths, the d4 width with
    # more items than the card holds blocks, an odd shape (H != W, head_dim
    # 48), several runs of rows per image, one window, and the general
    # kernels (head_dim 20 in bf16, 3, forced); a rank's heads under
    # --model-parallel 2 (phase 12: volo_d1's 3 of 6 at b=64, volo_d4's 6 of
    # 12 at b=8)
    shapes = ([(32, r, r, 192, 6, False) for r in (16, 20, 24, 28)]
              + [(64, 28, 28, 96, 3, False), (8, 28, 28, 192, 6, False)]
              + [(64, 28, 28, 192, 6, False), (128, 28, 28, 192, 6, False),
                 (8, 28, 28, 256, 8, False), (8, 28, 28, 384, 12, False),
                 (96, 28, 28, 384, 12, False),
                 (8, 10, 6, 96, 2, False), (3, 64, 64, 192, 6, False),
                 (5, 8, 12, 32, 2, False), (3, 2, 2, 8, 1, False),
                 (1, 64, 64, 40, 2, False), (2, 6, 6, 6, 2, False),
                 (32, 28, 28, 192, 6, True)])
    gen = torch.Generator("cuda").manual_seed(3)
    walked = 0
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for B, H, W, C, heads, general in shapes:
            v = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            logits = (2 * torch.randn(B, H // 2, W // 2, heads * 81, device="cuda",
                                      generator=gen)).to(dt)
            gout = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            scale = (C // heads) ** -0.5
            runs = [(O._launch_fwd(v, logits, heads, scale, general),
                     *O._launch_bwd(v, logits, gout, heads, scale, general))
                    for _ in range(2)]
            plans = dict(O.PLANS)
            torch.cuda.synchronize()
            tag = (f"B={B} H={H} W={W} C={C} heads={heads}"
                   + f" ({'rows' if plans['fwd']['rows'] else 'general'} forward "
                   f"{list(plans['fwd'].values())[1:-1]}, "
                   f"{'rows' if plans['bwd']['rows'] else 'general'} backward "
                   f"{list(plans['bwd'].values())[1:-1]})")
            out, dv, dlogits = runs[0]
            _check(f"K2 fwd {tag}", worst, "fwd", out,
                   O.outlook_attention_fused_reference(v, logits, heads, scale), dt_name)
            rdv, rdl = O.outlook_attention_backward_reference(v, logits, gout, heads, scale)
            _check(f"K2 bwd dv {tag}", worst, "bwd", dv, rdv, dt_name)
            _check(f"K2 bwd dlogits {tag}", worst, "bwd", dlogits, rdl, dt_name)
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"K2 {tag} {dt_name}: a second launch gave other bits")
            rows = (C // heads) * v.element_size() % 16 == 0 and not general
            if bool(plans["fwd"]["rows"]) != rows or bool(plans["bwd"]["rows"]) != rows:
                fail(f"K2 {tag} {dt_name}: took the {'general' if rows else 'row'} kernels")
            if any(p["heads"] != heads or (p["rows"] and heads % p["heads_per_block"])
                   for p in plans.values()):
                fail(f"K2 {tag} {dt_name}: a row plan's head group does not divide the "
                     f"launch's {heads} heads: {plans}")
            more = [B * p["runs"] * (heads // p["heads_per_block"]) > p["blocks"]
                    for p in plans.values() if p["rows"]]
            walked += sum(more)
            if (B, C) == (96, 384) and not (more and all(more)):
                fail(f"K2 {tag} {dt_name}: the row kernels had no more items than blocks")
    say(f"phase 3 K2: the same bits from a second launch at every shape; persistent blocks "
        f"walked more items than blocks in {walked} launches")
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
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


#: LayerNorm launches of the main path (phases 4 and 6), for the kernel report
LN_PATH = {"fwd": 0, "bwd": 0}
#: [rows, C] of every LayerNorm the benchmark's cells run (deit_small; volo_d1's
#: outlookers, transformers, class-attention norm1 and final norm, cls norm2),
#: a ragged row count, and the narrowest and widest rows the kernels take
LN_SHAPES = [(50432, 384), (100352, 192), (25088, 384), (25216, 384), (128, 384),
             (4099, 384), (517, 32), (517, 768), (517, 1024)]


def _ln_gap(torch, got, ref, dt_name):
    """Worst gap of a bf16 / f32 result to the twin's, as a share of the
    tolerance (<= 1 passes). bf16: 1 ulp of the larger of the two elements,
    since the two round the same f32 value once and the f32 values differ
    only in summation order, which flips a rounding at most, plus 2^-21 of
    the largest |value| for the elements where that order shows through a
    cancellation (y = xhat * gamma + beta near 0, dx's three terms); f32:
    1e-5 of the largest |value|."""
    g, r = got.float(), ref.float()
    top = max(float(r.abs().max()), 1e-30)
    if dt_name == "float32":
        return float((g - r).abs().max()) / (1e-5 * top)
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    ulp = (e.float() - 8).exp2()
    return float(((g - r).abs() / (ulp + 2.0 ** -21 * top)).max())


def _ln_rows(worst, times):
    """The kernel report's LayerNorm rows: launches on the main path (phases
    4 and 6), the worst bf16 gap to the twin and phase 15's times per shape."""
    return [{"name": f"layernorm_{side}", "route": "cuda", "source": LN_SRC,
             "replaces": "models/layers.py:LayerNorm (XLA in the JAX package)",
             "launches": LN_PATH[side],
             "max_abs_err": max(worst[name, "bfloat16"] for name in names),
             **{k: {shape: v[k][i] for shape, v in times.items()}
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
            for i, (side, names) in enumerate((("fwd", ("y",)),
                                               ("bwd", ("dx", "dgamma", "dbeta"))))]


def phase_layernorm(torch, card):
    """Phase 15: the LayerNorm kernels (`ops/layernorm.py`, `csrc/layernorm.cu`)
    against the plain twin on the card, the same bits twice, a `--remat full`
    step against the plain one, times and host cost. Returns the report's
    worst gaps and times."""
    import torch.nn.functional as F
    from autoprog_tpu_torch.ops import layernorm as LN
    t_phase = time.time()
    gen = torch.Generator("cuda").manual_seed(15)
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        for rows, C in LN_SHAPES:
            x = (torch.randn(rows, C, device="cuda", generator=gen) * 2 + 0.5).to(dt)
            dy = torch.randn(rows, C, device="cuda", generator=gen).to(dt)
            w = torch.randn(C, device="cuda", generator=gen)
            b = torch.randn(C, device="cuda", generator=gen)
            runs = []
            for _ in range(2):
                xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
                before = dict(LN.LAUNCHES)
                y = LN.layer_norm(xs, ws, bs, 1e-6, dt)
                runs.append((y.detach(), *torch.autograd.grad(y, (xs, ws, bs), dy)))
                if (LN.LAUNCHES["fwd"] - before["fwd"], LN.LAUNCHES["bwd"] - before["bwd"]) \
                        != (1, 2):
                    fail(f"LayerNorm [{rows}, {C}] {dt_name}: launches {LN.LAUNCHES} after "
                         f"{before}, not one forward and two backward")
            xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
            y = LN.layer_norm_reference(xs, ws, bs, 1e-6, dt)
            ref = (y.detach(), *torch.autograd.grad(y, (xs, ws, bs), dy))
            torch.cuda.synchronize()
            tag = f"[{rows}, {C}] {dt_name}"
            gaps = []
            for name, got, want in zip(("y", "dx", "dgamma", "dbeta"), runs[0], ref):
                if got.shape != want.shape or got.dtype != want.dtype or \
                        not bool(got.isfinite().all()):
                    fail(f"LayerNorm {name} {tag}: shape, dtype or finiteness differ from "
                         f"the twin's")
                gap = _ln_gap(torch, got, want, dt_name if name in ("y", "dx") else "float32")
                gaps.append(f"{name} {gap:.3f}")
                if not gap <= 1.0:
                    fail(f"LayerNorm {name} {tag}: {gap:.3f} of the tolerance from the twin")
                worst[name, dt_name] = max(worst.get((name, dt_name), 0.0),
                                           float((got.float() - want.float()).abs().max()))
            same = all(torch.equal(a, c) for a, c in zip(*runs))
            say(f"phase 15 LayerNorm {tag}: share of the tolerance {', '.join(gaps)}; second "
                f"run {'the same bits' if same else 'DIFFERENT bits'}")
            if not same:
                fail(f"LayerNorm {tag}: two runs gave different bits")
    say(f"phase 15 LayerNorm worst |kernel - twin|: {worst}")

    # one step under --remat full against the plain step (deit_small, b=16):
    # the repo's remat tolerance, 2 ulp of bf16 of the largest |gradient|
    from autoprog_tpu_torch import create_model
    torch.manual_seed(0)
    base = create_model("deit_small_patch16_224").make(num_classes=1000).state_dict()
    img = torch.randn(16, 224, 224, 3, device="cuda", generator=gen)
    label = torch.randint(0, 1000, (16,), device="cuda", generator=gen)
    res = {}
    for mode in ("", "full"):
        m = create_model("deit_small_patch16_224").make(num_classes=1000, remat=mode).cuda()
        m.load_state_dict(base)
        before = dict(LN.LAUNCHES)
        loss = F.cross_entropy(m(img, train=True).float(), label)
        loss.backward()
        res[mode] = (loss.detach(), {n: p.grad for n, p in m.named_parameters()},
                     {k: LN.LAUNCHES[k] - before[k] for k in before})
        del m
    (ref_loss, ref, ref_n), (loss, g, n) = res[""], res["full"]
    rel = max(float((g[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
              for k in ref)
    same = torch.equal(loss, ref_loss) and all(torch.equal(g[k], ref[k]) for k in ref)
    say(f"phase 15 remat full (deit_small b=16): loss {float(loss):.6f} against "
        f"{float(ref_loss):.6f}, {len(ref)} gradients {'bit for bit equal' if same else 'differ'}"
        f" (largest difference {rel:.3e} of the largest |gradient|); LN launches plain "
        f"{ref_n}, remat {n}")
    if rel > 2.0 ** -6 or float((loss - ref_loss).abs()) > 2.0 ** -6 * float(ref_loss.abs()):
        fail("--remat full: loss or gradients differ from the plain step's by more than 2 ulp "
             "of bf16")
    if ref_n != {"fwd": 25, "bwd": 50} or n != {"fwd": 49, "bwd": 50}:
        fail(f"LayerNorm launches {ref_n} plain / {n} remat, not 25 / 49 forwards and 50 "
             f"backwards")
    del res, ref, g

    # times (bf16): the kernels, the plain chain, one F.layer_norm on bf16
    times = {}
    for rows, C in ((50432, 384), (100352, 192)):
        x = torch.randn(rows, C, device="cuda", generator=gen).to(torch.bfloat16)
        dy = torch.randn_like(x)
        w, b = torch.randn(C, device="cuda", generator=gen), torch.zeros(C, device="cuda")
        _, stats = LN._launch_fwd(x, w, b, 1e-6)
        k_f = _time_cuda(torch, lambda: LN._launch_fwd(x, w, b, 1e-6), 200)
        k_b = _time_cuda(torch, lambda: LN._launch_bwd(x, dy, w, stats), 200)

        def chain_ms(fn, params):
            xs = x.clone().requires_grad_(True)
            f = _time_cuda(torch, lambda: fn(xs, *params), 20)
            y = fn(xs, *params)
            fb = _time_cuda(torch, lambda: torch.autograd.grad(
                y, (xs, *params), dy, retain_graph=True), 20)
            return f, fb
        wp, bp = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        p_f, p_b = chain_ms(lambda xs, ww, bb: LN.layer_norm_reference(
            xs, ww, bb, 1e-6, torch.bfloat16), (wp, bp))
        wl, bl = (t.to(torch.bfloat16).requires_grad_(True) for t in (w, b))
        l_f, l_b = chain_ms(lambda xs, ww, bb: F.layer_norm(xs, (C,), ww, bb, 1e-6), (wl, bl))
        nbytes = rows * C * 2
        key = f"[{rows}, {C}]"
        times[key] = {"ms": (k_f, k_b), "plain_ms": (p_f, p_b), "library_ms": (l_f, l_b),
                      "bound_ms": (_bound(2 * nbytes, 0, 1)[0], _bound(3 * nbytes, 0, 1)[0])}
        say(f"phase 15 LayerNorm times {key} bf16 on {card}: kernels fwd {k_f:.4f} / bwd "
            f"{k_b:.4f} ms (bound {times[key]['bound_ms'][0]:.4f} / "
            f"{times[key]['bound_ms'][1]:.4f}); plain chain fwd {p_f:.4f} / bwd {p_b:.4f}; "
            f"F.layer_norm on bf16 fwd {l_f:.4f} / bwd {l_b:.4f} ms")

    # host time a call at a shape where the host paces (device work of a few
    # microseconds): the kernels against the plain chain, forward alone and
    # forward + backward through autograd, in 60 blocks of 50 calls that
    # alternate which path goes first; the median block of each (the card's
    # host is shared, so single long blocks swing by tens of percent)
    x = torch.randn(128, 384, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn_like(x)
    w = torch.randn(384, device="cuda", generator=gen).requires_grad_(True)
    b = torch.zeros(384, device="cuda").requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    paths = {"kernels": LN.layer_norm, "plain": LN.layer_norm_reference}

    def fwd(fn):
        with torch.no_grad():
            fn(xs, w, b, 1e-6, torch.bfloat16)

    def fwd_bwd(fn):
        torch.autograd.grad(fn(xs, w, b, 1e-6, torch.bfloat16), (xs, w, b), dy)
    host = {}
    for what, body in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        for fn in paths.values():
            for _ in range(200):
                body(fn)
        torch.cuda.synchronize()
        for block in range(60):
            for name in (("plain", "kernels") if block % 2 else ("kernels", "plain")):
                t0 = time.perf_counter()
                for _ in range(50):
                    body(paths[name])
                host.setdefault((what, name), []).append((time.perf_counter() - t0) / 50 * 1e6)
                torch.cuda.synchronize()
    host = {k: statistics.median(v) for k, v in host.items()}
    say(f"phase 15 LayerNorm host time a call at [128, 384] bf16 (median of 60 alternating "
        f"blocks of 50): forward kernels {host['fwd', 'kernels']:.2f} us, plain chain "
        f"{host['fwd', 'plain']:.2f} us; forward + backward through autograd kernels "
        f"{host['fwd_bwd', 'kernels']:.2f} us, plain chain {host['fwd_bwd', 'plain']:.2f} us")
    if host["fwd_bwd", "kernels"] > host["fwd_bwd", "plain"]:
        say("phase 15 note: the kernels' host time a call is not below the plain chain's")
    say(f"phase 15: {time.time() - t_phase:.1f} s")
    return worst, times, host


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


def _check_ln(phase: str, got, per_step: int, steps: int) -> None:
    """A trainer run's LayerNorm launches: two backward launches a LayerNorm
    of every train step, and at least one forward (the eval pass adds
    forwards); added to `LN_PATH`."""
    say(f"{phase} launches: LN {got} (train steps {steps} x {per_step} LayerNorms, "
        f"backward two launches each = {2 * per_step * steps})")
    if got["bwd"] != 2 * per_step * steps or got["fwd"] < per_step * steps:
        fail(f"{phase}: LayerNorm launches {got} do not cover {per_step} LayerNorms x "
             f"{steps} steps")
    for k in LN_PATH:
        LN_PATH[k] += got[k]


def phase_trainer(torch, steps: int = 4, batch: int = 64):
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops.attention import LAUNCHES
    from autoprog_tpu_torch.ops.outlook_fused import LAUNCHES as OUTLOOK_LAUNCHES
    from autoprog_tpu_torch.ops.outlook_fused import ROUTES
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
    from autoprog_tpu_torch.ops.layernorm import LAUNCHES as LN_LAUNCHES
    from autoprog_tpu_torch.train.steps import GRAD_FILLS
    for counts in (LAUNCHES, OUTLOOK_LAUNCHES, ROUTES, GRAD_FILLS, LN_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    best = main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, outlook = dict(LAUNCHES), dict(OUTLOOK_LAUNCHES)
    _check_ln("phase 4", dict(LN_LAUNCHES), 41, steps)
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
    say(f"phase 4 K2 routes: {ROUTES}")
    say(f"phase 4 gradients filled with zeros (parameters no forward reached): "
        f"{GRAD_FILLS['params']}")
    if GRAD_FILLS["params"]:
        fail("the full-depth steps left parameters without a gradient")
    if ROUTES["fwd_general"] or ROUTES["bwd_general"] or \
            ROUTES["bwd_rows"] != outlook["bwd"] or ROUTES["fwd_rows"] != outlook["fwd"]:
        fail(f"volo_d1's steps did not all go through K2's row kernels: {ROUTES}")
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
    return launches, outlook, run, argv[:-2]


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
    from autoprog_tpu_torch.train.steps import GRAD_FILLS
    for counts in (A.LAUNCHES, O.LAUNCHES, O.ROUTES, GRAD_FILLS):
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
    say(f"phase 5 gradients filled with zeros (the layers the supernet's keep masks "
        f"skipped): {GRAD_FILLS['params']}")
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
    if O.ROUTES["fwd_general"] or O.ROUTES["bwd_general"]:
        fail(f"the progressive run took K2's general kernels: {O.ROUTES}")
    if k1["bwd"] != want_k1 or k1["fwd"] < want_k1:
        fail(f"K1 launches {k1} do not cover every transformer layer of every step")
    for name in ("last-search.ckpt", "last.ckpt"):
        if not os.path.exists(os.path.join(run, name)):
            fail(f"{name} was not written")
    ckpt = torch.load(os.path.join(run, "last.ckpt"), map_location="cpu", weights_only=False)
    if ckpt["arch"] != "volo_h12_l18" or ckpt["stage_info"]["l"] != 18 or \
            not all(torch.isfinite(v).all() for v in ckpt["state_dict"].values()):
        fail("last.ckpt does not hold a finite volo_h12_l18")
    return k1, k2, run, argv[:-2]


def _reset_mhsa_counts():
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    for k in A.LAUNCHES:
        A.LAUNCHES[k] = 0
    for k in V.LAUNCHES:
        V.LAUNCHES[k] = 0
    X.LAUNCHES.clear()
    V.RAN.clear()
    X.RAN.clear()


def phase_deit(torch, card, steps: int = 4, batch: int = 64):
    """deit_small through the fixed trainer at full width, then two steps of
    the distilled variant, then the step time on a device-resident batch."""
    import argparse
    from autoprog_tpu_torch import create_model
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops.attention import LAUNCHES
    from autoprog_tpu_torch.ops.layernorm import LAUNCHES as LN_LAUNCHES
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
        for k in LN_LAUNCHES:
            LN_LAUNCHES[k] = 0
        t0 = time.time()
        best = main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        _check_ln("phase 6", dict(LN_LAUNCHES), 25, n_steps)
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
    of K5 and of every variant over this phase and {row: the kernels its
    launches ran}."""
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
    rows = X.main(["128"])
    # the bench's own check: every variant bit for bit K1 at f32 scores
    unequal = [r["name"] for r in rows if not r["name"].startswith("base")
               and not (r["fwd_equal"] and r["bwd_equal"])]
    if unequal or len(rows) != 2 + len(GROUPS):
        fail(f"bench_attn_x 128: not K1's bits at f32 scores: {unequal} ({len(rows)} rows)")
    counts = {"mhsa_fwd": A.LAUNCHES["fused_fwd"], "mhsa_bwd": A.LAUNCHES["fused_bwd"],
              **V.LAUNCHES, **X.LAUNCHES}
    say(f"phase 7 launches by the two benches: {counts}")
    want = ["mhsa_fwd", "mhsa_bwd", *V._KERNELS] + [
        X.variant_name(o, G) + side for o, G in GROUPS for side in ("_fwd", "_bwd")]
    missing = [k for k in want if counts.get(k, 0) <= 0]
    if missing:
        fail(f"the benches did not launch {missing}")
    ran = {**V.RAN, **X.RAN}
    say(f"phase 7 kernels the variants launched, as the library counted them: "
        f"{ {f'{key} {kernels}': c for (key, kernels), c in ran.items()} }")
    wrong = [f"{key}: {kernels}" for key, kernels in ran
             if kernels != V.expected_kernels(key, True)]
    if wrong:
        fail(f"a variant did not launch its resident kernels at the benches' shape: {wrong}")
    kernels = {}
    for key, names in ran:
        kernels.setdefault(key, set()).add(names)
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
    return counts, {key: "+".join(sorted(v)) for key, v in kernels.items()}


def _time_cuda(torch, fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call between two CUDA events, after a warm-up."""
    from autoprog_tpu_torch.scripts.timing import time_call
    return time_call(fn, iters, warmup)


def phase_kernel_times(torch, card):
    """K1 at the volo_d1 shape, with `F.scaled_dot_product_attention` (one
    PyTorch call for the same function, used nowhere in the port) beside
    it."""
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
    # the backward is fed the forward's statistics, as autograd feeds it
    stats = A._launch_fwd(qkv, H, scale, False, want_stats=True)[1]
    t = {
        "fwd": _time_cuda(torch, lambda: A._launch_fwd(qkv, H, scale, False), 50),
        "bwd": _time_cuda(torch, lambda: A._launch_bwd(qkv, dout, H, scale, False, stats), 50),
        "plain_fwd": _time_cuda(torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale), 20),
        "plain_bwd": _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale), 20),
        "lib_fwd": _time_cuda(torch, lambda: sdpa(qkv), 50),
        "lib_bwd": _time_cuda(torch, lambda: torch.autograd.grad(
            lib_out, leaf, dout, retain_graph=True), 50),
    }
    # least time: K1's work (`scripts/cost.py`) at the bf16 peak
    from autoprog_tpu_torch.scripts import cost
    C = H * d
    for side in ("fwd", "bwd"):
        flops, nbytes = cost.k1_work(side, B, n, H, d)
        t["bound_" + side], t["by_" + side] = _bound(nbytes, flops, cost.BF16_FLOPS)
    say(f"phase 8 K1 [B={B}, n={n}, C={C}, heads={H}] bf16 on {card}: "
        f"fwd {t['fwd']:.4f} ms (plain {t['plain_fwd']:.4f}, SDPA {t['lib_fwd']:.4f}, bound "
        f"{t['bound_fwd']:.4f} by {t['by_fwd']}), bwd {t['bwd']:.4f} ms (plain "
        f"{t['plain_bwd']:.4f}, SDPA backward {t['lib_bwd']:.4f}, bound {t['bound_bwd']:.4f} "
        f"by {t['by_bwd']})")
    return t


def phase_k1_shape_times(torch, card):
    """K1 at its default (bf16) scores and at f32 scores beside `loop_img1`
    (S1 at G = 1, f32 scores), SDPA and the bound, forward and
    backward, at every shape a trainer gives it: `scripts.bench_k1`'s table
    with the library call timed in the same turns. The backward is fed the
    forward's statistics, as autograd feeds it. Returns {(side, n): row} and
    loop_img1's launch counts over this phase."""
    import torch.nn.functional as F
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    from autoprog_tpu_torch.scripts import bench_k1, cost
    rows = {}
    X.LAUNCHES.clear()
    for B, n, H, d in bench_k1.SHAPES:
        C, scale = H * d, d ** -0.5
        qkv, dout = bench_k1.inputs(B, n, H, d, torch.device("cuda"), seed=8)
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = leaf.view(B, n, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)

        def sdpa():
            o = F.scaled_dot_product_attention(q, k, v, scale=scale)
            return o.permute(0, 2, 1, 3).reshape(B, n, C)

        lib_out = sdpa()
        ms = bench_k1.time_shape(qkv, dout, H, 30, 3, extra={
            "lib fwd": sdpa,
            "lib bwd": lambda: torch.autograd.grad(lib_out, leaf, dout, retain_graph=True)})
        ms["plain fwd"] = _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale), 5, 1)
        ms["plain bwd"] = _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale), 5, 1)
        bound = {}
        for side in ("fwd", "bwd"):
            flops, nbytes = cost.k1_work(side, B, n, H, d)
            bound[side] = _bound(nbytes, flops, cost.BF16_FLOPS)
        for side in ("fwd", "bwd"):
            t = {"bf16": ms[side], "f32": ms[side + " f32"], "loop1": ms["loop_img1 " + side],
                 "lib": ms["lib " + side], "plain": ms["plain " + side]}
            say(f"phase 8 K1 {side} [B={B}, n={n}, C={C}, heads={H}] bf16 on {card}: "
                f"{t['bf16']:.4f} ms at bf16 scores, {t['f32']:.4f} at f32 scores"
                + (f", {ms['fwd +stats']:.4f} writing the statistics" if side == "fwd" else "")
                + f"; loop_img1 (S1 at G = 1) {t['loop1']:.4f}, SDPA {t['lib']:.4f}, plain "
                f"{t['plain']:.4f}, bound {bound[side][0]:.4f} by {bound[side][1]}; loop_img1 "
                f"takes {t['loop1'] / t['f32']:.2f}x the time of K1 at f32 scores, K1 is "
                f"{t['lib'] / t['bf16']:.2f}x SDPA, bf16 scores {t['bf16'] / t['f32']:.3f}x the "
                f"time of f32 scores")
            rows[side, n] = {**t, "bound": bound[side]}
    return rows, dict(X.LAUNCHES)


def phase_mhsa_variant_times(torch, card, t_k1):
    """K5 and every variant at the volo_d1 shape beside its twin, K1 at the
    variant's score type, SDPA (K1's library yardstick, timed in
    phase_kernel_times) and the bound. Returns {row: {ms, plain_ms,
    library_ms, bound_ms, bound_by}}."""
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
    # the variants' twins are K1's at the variant's score type; the S1
    # backwards compute their row statistics, as K1 does when given none
    plain = {
        ("fwd", True): _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_reference(qkv, H, scale, True), 20),
        ("bwd", True): _time_cuda(
            torch, lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, scale, True), 20),
        ("fwd", False): t_k1["plain_fwd"],
    }
    k1 = {("fwd", True): _time_cuda(torch, lambda: A._launch_fwd(qkv, H, scale, True), 50),
          ("fwd", False): _time_cuda(torch, lambda: A._launch_fwd(qkv, H, scale, False), 50),
          ("bwd", True): _time_cuda(torch, lambda: A._launch_bwd(qkv, dout, H, scale, True), 30)}
    rows = {  # row: (the call, plain ms, side, K1's key)
        "mhsa_fwd": (lambda: A._launch_fused_fwd(q, k, v, scale),
                     _time_cuda(torch, lambda: A.mhsa_fused_reference(q, k, v, scale), 20),
                     "fwd", ("fwd", True)),
        "mhsa_bwd": (lambda: A._launch_fused_bwd(q, k, v, g4, scale),
                     _time_cuda(torch, lambda: A.mhsa_fused_backward_reference(
                         q, k, v, g4, scale), 20), "bwd", ("bwd", True)),
    }
    for name in V._KERNELS:
        sf = V.SCORES_F32[name]
        rows[name] = (lambda name=name: V._launch(name, qkv, H, scale), plain[("fwd", sf)],
                      "fwd", ("fwd", sf))
    for order, G in GROUPS + [("loop", 1)]:
        key = X.variant_name(order, G)
        rows[key + "_fwd"] = (lambda o=order, G=G: X._launch_group_fwd(o, G, qkv, H, scale),
                              plain[("fwd", True)], "fwd", ("fwd", True))
        rows[key + "_bwd"] = (
            lambda o=order, G=G: X._launch_group_bwd(o, G, qkv, dout, H, scale),
            plain[("bwd", True)], "bwd", ("bwd", True))
    # the same bytes and products as K1: q, k, v and out (forward), or q, k,
    # v, dout and three gradients (backward), moved once
    out = {}
    for key, (call, plain_ms, side, k1_key) in rows.items():
        ms = _time_cuda(torch, call, 50 if side == "fwd" else 30)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": t_k1["lib_" + side],
                    "bound_ms": t_k1["bound_" + side], "bound_by": t_k1["by_" + side]}
        say(f"phase 8 {key} [B={B}, n={n}, C={H * d}, heads={H}] bf16 on {card}: {ms:.4f} ms "
            f"(K1 at scores_f32={int(k1_key[1])} {k1[k1_key]:.4f}; SDPA "
            f"{t_k1['lib_' + side]:.4f}; bound {t_k1['bound_' + side]:.4f} by "
            f"{t_k1['by_' + side]}; plain {plain_ms:.4f})")
    return out


def _bound(nbytes: float, flops: float, peak: float):
    """(least ms, what sets it): bytes over the HBM rate against operations
    over the peak of their type (`scripts/cost.py`)."""
    from autoprog_tpu_torch.scripts.cost import least_ms
    return least_ms(nbytes, flops, peak)


def phase_outlook_times(torch, card):
    """One outlooker layer's op at the volo_d1 shape through the unfused
    path, K2, K3 and K4 (forward, and forward + backward through autograd),
    then each kernel alone beside its plain twin. The K3 / K4 launch counts
    of the report are read over this phase's variants run."""
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.ops.outlook import outlook_attention
    from autoprog_tpu_torch.scripts import cost
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
    # K2 per map (`scripts.bench_k2`): the row kernels beside the general
    # kernels (K2 before the row kernels) and the unfused op, in the same turns
    from autoprog_tpu_torch.scripts import bench_k2
    table = {}
    for Bk, Hk, Ck, hk, dk in bench_k2.SHAPES:
        vk, lk, gk = bench_k2.inputs(Bk, Hk, Ck, hk, torch.device("cuda"), seed=9, dtype=dk)
        ms = bench_k2.time_shape(vk, lk, gk, hk, 30, 3)
        lim = bench_k2.bound(Bk, Hk, Hk, Ck, hk, vk.element_size())
        table[Bk, Hk, Ck, hk, dk] = ms
        say(f"phase 8 K2 [{Bk}, {Hk}, {Hk}, {Ck}, {hk} heads] {dk} on {card}: fwd "
            f"{ms['fwd']:.4f} ms (general {ms['general fwd']:.4f}, unfused "
            f"{ms['unfused fwd']:.4f}, bound {lim['fwd'][0]:.4f} by {lim['fwd'][1]}, "
            f"{lim['fwd'][0] / ms['fwd']:.0%} of its rate), bwd {ms['bwd']:.4f} ms (general "
            f"{ms['general bwd']:.4f}, unfused forward + backward {ms['unfused fwd+bwd']:.4f}, "
            f"bound {lim['bwd'][0]:.4f} by {lim['bwd'][1]}, "
            f"{lim['bwd'][0] / ms['bwd']:.0%} of its rate)")
    main_ms, f32_ms = table[B, H, C, heads, "bf16"], table[B, H, C, heads, "f32"]
    t = {
        "fwd": main_ms["fwd"], "general_fwd": main_ms["general fwd"],
        "bwd": main_ms["bwd"], "general_bwd": main_ms["general bwd"],
        "f32_fwd": f32_ms["fwd"], "f32_general_fwd": f32_ms["general fwd"],
        "f32_bwd": f32_ms["bwd"], "f32_general_bwd": f32_ms["general bwd"],
        "plain_fwd": _time_cuda(
            torch, lambda: O.outlook_attention_fused_reference(v, logits, heads, scale), 10),
        "plain_bwd": _time_cuda(torch, lambda: O.outlook_attention_backward_reference(
            v, logits, gout, heads, scale), 10),
    }
    for key, hm in (("attend_hm", True), ("attend", False)):
        t[key] = _time_cuda(torch, lambda: O._launch_attend(patches, att, heads, scale, hm), 50)
        t["plain_" + key] = _time_cuda(
            torch, lambda: O.outlook_attend_reference(patches, att, heads, scale, hm), 5)
    # bytes: every input read once, every output written once; operations:
    # 81 multiply-adds per window, head and channel of the head, in f32
    lim = bench_k2.bound(B, H, H, C, heads)
    (t["bound_fwd"], t["by_fwd"]), (t["bound_bwd"], t["by_bwd"]) = lim["fwd"], lim["bwd"]
    log_b, patch_b = B * n * heads * 81 * 2, B * n * 9 * C * 2
    attend_flops = 2 * B * n * 81 * C
    for key in ("attend_hm", "attend"):
        t["bound_" + key], t["by_" + key] = _bound(2 * patch_b + log_b, attend_flops,
                                                   cost.F32_FLOPS)
    say(f"phase 8 K2 alone on {card}: fwd {t['fwd']:.4f} ms (general {t['general_fwd']:.4f}, "
        f"plain {t['plain_fwd']:.4f}, bound {t['bound_fwd']:.4f} by {t['by_fwd']}), bwd "
        f"{t['bwd']:.4f} ms (general {t['general_bwd']:.4f}, plain "
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


def _counted(torch, run):
    """Run `run()` with K1's and K2's counts set to 0 just before; returns
    its result and the launches it made (K1, K2, K2's routes)."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    for counts in (A.LAUNCHES, O.LAUNCHES, O.ROUTES):
        for k in counts:
            counts[k] = 0
    out = run()
    torch.cuda.synchronize()
    return (out, {k: A.LAUNCHES[k] for k in ("fwd", "bwd")},
            {k: O.LAUNCHES[k] for k in ("fwd", "bwd")}, dict(O.ROUTES))


def _first_epoch_hook(check):
    """Wrap engine.train_one_epoch so that `check(ctx, epoch)` sees the state
    before the first step of the run; returns the restore function."""
    from autoprog_tpu_torch import engine
    original = engine.train_one_epoch
    seen = []

    def wrapped(ctx, epoch, *a, **kw):
        if not seen:
            seen.append(epoch)
            check(ctx, epoch)
        return original(ctx, epoch, *a, **kw)
    engine.train_one_epoch = wrapped

    def restore():
        engine.train_one_epoch = original
        if not seen:
            fail("the run took no train epoch")
    return restore


def phase_checkpoint(torch, card, fixed_run, fixed_argv, prog_run, prog_argv, batch: int = 128):
    """The checkpoint path on phase 4's and phase 5's files: validate against
    the trainer's eval row, a fixed and a progressive resume, a finetune into
    100 classes, then the eval forward's time. Returns K1's and K2's launches
    over the phase's runs."""
    import csv
    from autoprog_tpu_torch import create_model, main as fixed_main, main_prog, validate
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    os.environ.pop("AUTOPROG_FUSED_ATTN", None)
    os.environ.pop("AUTOPROG_FUSED_OUTLOOK", None)
    k1, k2 = {"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}

    def add(a1, a2):
        for side in ("fwd", "bwd"):
            k1[side] += a1[side]
            k2[side] += a2[side]

    # validate on phase 4's model_best.ckpt: the trainer's 64 eval samples in
    # one batch of 64, bf16, K1 and K2 on
    with open(os.path.join(fixed_run, "summary.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    best = os.path.join(fixed_run, "model_best.ckpt")
    for flags, suffix in (([], ""), (["--use-ema", "--ema-idx", "3"], "_EMA_0.9996")):
        argv = ["synthetic://", "--checkpoint", best, "--num-classes", "1000", "--img-size",
                "224", "-b", "64", "--workers", "0", "--fake-data-size", "64"] + flags
        t0 = time.time()
        res, a1, a2, routes = _counted(torch, lambda: validate.main(argv)[0])
        add(a1, a2)
        want = {k: float(row[f"eval_{k}{suffix}"]) for k in ("top1", "top5", "loss")}
        got = {k: res[k] for k in want}
        say(f"phase 9 python -m autoprog_tpu_torch.validate {' '.join(argv)} "
            f"({time.time() - t0:.1f} s): {got}; trainer's row {want}; launches K1 {a1}, "
            f"K2 {a2}")
        if got != want or res["count"] != 64:
            fail(f"validate's metrics {got} are not the trainer's {want}")
        if a1 != {"fwd": 14, "bwd": 0} or a2 != {"fwd": 4, "bwd": 0} or \
                routes["fwd_rows"] != 4:
            fail(f"validate's one batch did not launch K1 14 times and K2's row kernels 4 "
                 f"times: {a1}, {a2}, {routes}")

    # fixed resume of phase 4's last.ckpt for one more epoch (4 steps)
    last = os.path.join(fixed_run, "last.ckpt")
    ckpt = load_checkpoint_file(last)

    def same_state(ctx, epoch, want_epoch, ck, emas=4):
        state = ctx.state
        bad = [n for n, p in state.params.items() if not torch.equal(p.detach().cpu(),
                                                                      ck["state_dict"][n])]
        bad += [f"ema{i}.{n}" for i in range(emas) for n, t in state.ema_params[i].items()
                if not torch.equal(t.cpu(), ck[f"state_dict_ema_{i}"][n])]
        saved, got = ck["optimizer"]["state"], state.optimizer.state_dict()["state"]
        bad += [f"opt{i}.{k}" for i in saved for k in ("exp_avg", "exp_avg_sq")
                if not torch.equal(got[i][k].cpu(), saved[i][k])]
        say(f"phase 9 resumed at epoch {epoch} (checkpoint epoch {ck['epoch']}), step "
            f"{state.step}: {len(state.params)} parameters, {emas} EMA trees and "
            f"{2 * len(saved)} Adam moments compared, {len(bad)} differ")
        if epoch != want_epoch or state.step != ck["step"] or bad:
            fail(f"the resumed state is not the checkpoint's: epoch {epoch}, {bad[:5]}")

    out = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    restore = _first_epoch_hook(lambda ctx, e: same_state(ctx, e, ckpt["epoch"] + 1, ckpt))
    argv = fixed_argv + ["--epochs", "2", "--resume", last, "--output", out]
    t0 = time.time()
    try:
        _, a1, a2, _ = _counted(torch, lambda: fixed_main.main(argv))
    finally:
        restore()
    add(a1, a2)
    log = open(glob.glob(os.path.join(out, "train", "*", "log.txt"))[0]).read()
    losses = [float(v) for v in re.findall(r"Train: 1 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    say(f"phase 9 resume: python -m autoprog_tpu_torch.main ... --epochs 2 --resume "
        f"last.ckpt ({time.time() - t0:.1f} s incl. two eval passes): losses {losses}; "
        f"launches K1 {a1}, K2 {a2}")
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
        fail(f"expected 4 finite losses after the resume, got {losses}")
    if a1["bwd"] != 56 or a1["fwd"] < 56 or a2["bwd"] != 16 or a2["fwd"] < 16:
        fail(f"the resumed steps did not launch K1 / K2 as phase 4's: {a1}, {a2}")
    del ckpt

    # progressive resume of phase 5's epoch-2 checkpoint (after the growth to
    # r=224, l=18): one more epoch of 5 steps at that stage
    snap = os.path.join(prog_run, "checkpoint-2.ckpt")
    pk = load_checkpoint_file(snap)
    out = tempfile.mkdtemp(prefix="chip_smoke_prog_resume_")
    restore = _first_epoch_hook(lambda ctx, e: same_state(ctx, e, 3, pk))
    t0 = time.time()
    try:
        _, a1, a2, _ = _counted(torch, lambda: main_prog.main(prog_argv + ["--resume", snap,
                                                                   "--output", out]))
    finally:
        restore()
    add(a1, a2)
    ctx = main_prog.LAST_CTX
    hist = ctx.stage_history
    final = load_checkpoint_file(glob.glob(os.path.join(out, "train", "*", "last.ckpt"))[0])
    say(f"phase 9 progressive resume of checkpoint-2.ckpt (arch {pk['arch']}, stage "
        f"{pk['stage_info']}, step {pk['step']}) ({time.time() - t0:.1f} s): history "
        f"{[(h['epoch'], h['r'], h['l']) for h in hist]}, arch {ctx.mdef.name}, final step "
        f"{final['step']}; launches K1 {a1}, K2 {a2}")
    if pk["arch"] != "volo_h12_l18" or ctx.mdef.name != pk["arch"] or \
            [(h["epoch"], h["r"], h["l"]) for h in hist] != [(3, 224, 18)]:
        fail("the progressive resume did not rebuild the recorded stage")
    # the step restarts with the stage's fresh state (as the JAX package's):
    # one epoch of 5 steps after the growth at epoch 2, then 5 more
    if pk["step"] != 5 or final["step"] != 10:
        fail(f"steps {pk['step']} -> {final['step']}, not 5 -> 10")
    if a1["bwd"] != 70 or a2["bwd"] != 20:
        fail(f"the resumed steps did not launch K1 14 and K2 4 times each: {a1}, {a2}")
    del pk

    # finetune phase 4's checkpoint into 100 classes, 2 steps
    src = load_checkpoint_file(best)["state_dict"]
    heads = ("head.weight", "head.bias", "aux_head.weight", "aux_head.bias")

    def finetuned(ctx, epoch):
        params = ctx.state.params
        bad = [n for n, p in params.items()
               if n not in heads and not torch.equal(p.detach().cpu(), src[n])]
        shapes = {n: tuple(params[n].shape) for n in heads}
        say(f"phase 9 finetune: {len(params) - len(heads)} parameters compared with the "
            f"checkpoint, {len(bad)} differ; heads re-initialised at {shapes}")
        if bad or shapes["head.weight"] != (100, 384) or shapes["aux_head.bias"] != (100,):
            fail(f"the finetuned model is not the checkpoint's with new heads: {bad[:5]}")

    out = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    argv = ["synthetic://", "--model", "volo_d1", "--img-size", "224", "-b", "64",
            "--num-classes", "100", "--token-label", "--token-label-data", "synthetic",
            "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr", "1e-4",
            "--fake-data-size", "128", "--workers", "6", "--log-interval", "1",
            "--finetune", best, "--output", out]
    restore = _first_epoch_hook(finetuned)
    try:
        _, a1, a2, _ = _counted(torch, lambda: fixed_main.main(argv))
    finally:
        restore()
    add(a1, a2)
    log = open(glob.glob(os.path.join(out, "train", "*", "log.txt"))[0]).read()
    losses = [float(v) for v in re.findall(r"Train: 0 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    say(f"phase 9 finetune into 100 classes: losses {losses}; launches K1 {a1}, K2 {a2}")
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses) or a1["bwd"] != 28:
        fail(f"expected 2 finite finetune steps through K1, got {losses}, {a1}")
    del src

    # the eval forward alone: volo_d1, b=128, 224 px, bf16, on a
    # device-resident batch; K1 and K2 on against both off, in turns
    torch.manual_seed(0)
    model = create_model("volo_d1").make(num_classes=1000, dtype=torch.bfloat16).cuda()
    x = torch.randn(batch, 224, 224, 3, device="cuda")
    ms = {"on": [], "off": []}
    with torch.no_grad():
        for turn in ("on", "off", "off", "on"):
            value = "1" if turn == "on" else "0"
            os.environ["AUTOPROG_FUSED_ATTN"] = os.environ["AUTOPROG_FUSED_OUTLOOK"] = value
            ms[turn].append(_time_cuda(torch, lambda: model(x, train=False), 10))
    del os.environ["AUTOPROG_FUSED_ATTN"], os.environ["AUTOPROG_FUSED_OUTLOOK"]
    on, off = sum(ms["on"]) / 2, sum(ms["off"]) / 2
    say(f"phase 9 volo_d1 eval forward b={batch} 224px bf16 on {card}: K1 + K2 {on:.3f} ms "
        f"({batch / on * 1e3:.1f} img/s; runs {ms['on']}), AUTOPROG_FUSED_ATTN=0 "
        f"AUTOPROG_FUSED_OUTLOOK=0 {off:.3f} ms ({batch / off * 1e3:.1f} img/s; runs "
        f"{ms['off']})")
    del model
    return k1, k2


def _grab_json(fn):
    """Run `fn()` with stdout captured; its one JSON line, echoed, parsed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1:
        fail(f"expected one JSON line on stdout, got {len(lines)}")
    return json.loads(lines[0]), lines[0]


def _watched_steps(torch, record):
    """Wrap StepBuilder.train_step so that `record(state, before, launches)`
    sees each step: the EMA trees before it and the K1 / K2 launches it
    made. Returns the restore function."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.train.steps import StepBuilder
    original = StepBuilder.train_step

    def wrapped(self, state, *a, **kw):
        before = [{n: t.clone() for n, t in tree.items()} for tree in state.ema_params]
        k0 = (A.LAUNCHES["fwd"], A.LAUNCHES["bwd"], O.LAUNCHES["fwd"], O.LAUNCHES["bwd"])
        out = original(self, state, *a, **kw)
        k1 = (A.LAUNCHES["fwd"], A.LAUNCHES["bwd"], O.LAUNCHES["fwd"], O.LAUNCHES["bwd"])
        record(state, before, tuple(b - a_ for a_, b in zip(k0, k1)))
        return out
    StepBuilder.train_step = wrapped

    def restore():
        StepBuilder.train_step = original
    return restore


def _trainer_log(out):
    run = glob.glob(os.path.join(out, "train", "*"))[0]
    log = open(os.path.join(run, "log.txt")).read()
    return run, log, [float(v) for v in re.findall(r"Train: 0 \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]


def phase_options(torch, card, batch: int = 64, big: int = 128):
    """The train step's options on the card: the trainer with
    uint8 batches erased on the device, sparse token labels and bf16 EMA and
    Adam state; remat against the plain step; the sparse target against the
    dense one; the bench's knobs; SGD under the profiler; the per-segment
    times. Returns K1's and K2's launches over the phase."""
    import argparse
    from autoprog_tpu_torch import bench, create_model, main as fixed_main
    from autoprog_tpu_torch.data.token_label import (
        build_token_label_target, sparse_token_label_target)
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.ops.interpolate import resize_bilinear
    from autoprog_tpu_torch.scripts import bench_parts
    from autoprog_tpu_torch.scripts.timing import time_call
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    dev = torch.device("cuda")
    for env in ("AUTOPROG_FUSED_ATTN", "AUTOPROG_FUSED_OUTLOOK", "AUTOPROG_SPARSE_TL",
                "AUTOPROG_BENCH_EMA_BF16", "AUTOPROG_BENCH_MU_BF16"):
        os.environ.pop(env, None)
    k1, k2 = {"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}

    def counted(run):
        out, a1, a2, _ = _counted(torch, run)
        for side in ("fwd", "bwd"):
            k1[side] += a1[side]
            k2[side] += a2[side]
        return out, a1, a2

    model, img = "volo_d1", 224
    layers = create_model(model).arch.layers
    n_ol, n_tr = layers[0], sum(layers[1:])     # 4 outlookers, 14 transformer blocks
    decays = ("0.998", "0.9986", "0.999", "0.9996")
    base_argv = ["synthetic://", "--model", model, "--img-size", str(img), "-b", str(batch),
                 "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr",
                 "1e-3", "--workers", "6", "--log-interval", "1"]

    # 1. the options on the trainer: 3 steps
    steps, seen = 3, []

    def record(state, before, launches):
        changed = [sum(int((t != before[i][n]).sum()) for n, t in tree.items())
                   for i, tree in enumerate(state.ema_params)]
        dtypes = {t.dtype for tree in state.ema_params for t in tree.values()}
        mu = {s["exp_avg"].dtype for s in state.optimizer.state.values()}
        seen.append((launches, changed, dtypes, mu))

    out = tempfile.mkdtemp(prefix="chip_smoke_options_")
    argv = base_argv + ["--token-label", "--token-label-data", "synthetic", "--model-ema",
                        "--model-ema-decay", *decays, "--uint8-pipe", "--reprob", "0.25",
                        "--model-ema-bf16", "--adam-mu-bf16", "--fake-data-size",
                        str(steps * batch), "--output", out]
    os.environ["AUTOPROG_SPARSE_TL"] = "1"
    restore = _watched_steps(torch, record)
    t0 = time.time()
    try:
        counted(lambda: fixed_main.main(argv))
    finally:
        restore()
        del os.environ["AUTOPROG_SPARSE_TL"]
    _, log, losses = _trainer_log(out)
    say(f"phase 10 options: AUTOPROG_SPARSE_TL=1 python -m autoprog_tpu_torch.main "
        f"{' '.join(argv[:-2])} ({time.time() - t0:.1f} s incl. data and eval): losses "
        f"{losses}")
    for i, (launches, changed, dtypes, mu) in enumerate(seen):
        say(f"phase 10 options step {i}: K1 fwd/bwd, K2 fwd/bwd launches {launches}; EMA "
            f"elements changed per decay {changed}; EMA dtypes {sorted(map(str, dtypes))}; "
            f"exp_avg dtypes {sorted(map(str, mu))}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"expected {steps} finite losses, got {losses}")
    if len(seen) != steps or any(
            launches != (n_tr, n_tr, n_ol, n_ol)
            or min(changed) <= 0 or dtypes != {torch.bfloat16} or mu != {torch.bfloat16}
            for launches, changed, dtypes, mu in seen):
        fail("the options' steps did not launch K1 / K2 once a layer, keep bf16 EMA trees "
             "that move every step and a bf16 exp_avg")

    # 2. remat: one step's loss and gradients against the plain step, then
    # the step's time and peak memory
    rs = torch.Generator(dev).manual_seed(10)
    t = img // 16

    def synthetic(b):
        scores = torch.rand(b, 5, 14, 14, device=dev, generator=rs)
        return {"image": torch.randn(b, img, img, 3, device=dev, generator=rs),
                "label": torch.randint(0, 1000, (b,), device=dev, generator=rs),
                "label_scores": scores / (scores.sum(1, keepdim=True) * 1.25),
                "label_inds": torch.randint(0, 1000, (b, 5, 14, 14), device=dev,
                                            generator=rs, dtype=torch.int32)}

    args = argparse.Namespace(opt="adamw", opt_betas=None, opt_eps=None, weight_decay=0.05,
                              token_label=True, token_label_size=t, ground_truth=False,
                              dense_weight=0.5, cls_weight=1.0, jsd=False, aug_splits=0)
    loss_fn = build_train_loss(args)
    torch.manual_seed(0)
    base = create_model(model).make(num_classes=1000, img_size=img).state_dict()

    def make(mode, dp=0.1):
        m = create_model(model).make(num_classes=1000, img_size=img, drop_path_rate=dp,
                                     remat=mode).to(dev)
        m.load_state_dict(base)
        sb = StepBuilder(train_loss=loss_fn, ema_decays=tuple(map(float, decays)),
                         num_classes=1000, token_label=True, has_token_label_data=True,
                         device=dev, seed=0)
        return m, sb

    data = synthetic(batch)
    bbox = torch.tensor([t // 7, t // 5, t // 2, 2 * t // 3], dtype=torch.int32)
    grads = {}
    for mode in ("", "full", "dots"):
        m, sb = make(mode)

        def one():
            o = m(resize_bilinear(data["image"], img), train=True, bbox=bbox,
                  drop_gen=sb.drop_gen, mix_gen=sb.mix_gen)
            loss = loss_fn(o, sb.build_target(data, img))
            loss.backward()
            return loss.detach()
        loss, a1, a2 = counted(one)
        grads[mode] = (loss, {n: p.grad for n, p in m.named_parameters()}, a1, a2)
        del m, sb
    ref_loss, ref, r1, r2 = grads[""]
    say(f"phase 10 remat b={batch} drop-path 0.1: plain loss {float(ref_loss):.6f}, K1 "
        f"{r1}, K2 {r2}")
    for mode in ("full", "dots"):
        loss, g, a1, a2 = grads[mode]
        same = torch.equal(loss, ref_loss) and all(torch.equal(g[n], ref[n]) for n in ref)
        worst = max(float((g[n] - ref[n]).abs().max()) / max(float(ref[n].abs().max()), 1e-30)
                    for n in ref)
        say(f"phase 10 remat {mode}: loss {float(loss):.6f}, {len(ref)} gradients "
            f"{'bit for bit equal to' if same else 'differ from'} the plain step's (largest "
            f"difference {worst:.3e} of the largest |gradient|); K1 {a1}, K2 {a2}")
        if worst > 2.0 ** -6 or float((loss - ref_loss).abs()) > 2.0 ** -6 * float(
                ref_loss.abs()):
            fail(f"--remat {mode}: the gradients differ from the plain step's by more than "
                 f"2 ulp of bf16")
        if r1["fwd"] != n_tr or a1["fwd"] != 2 * n_tr or a2["fwd"] != 2 * n_ol or \
                a1["bwd"] != n_tr or a2["bwd"] != n_ol:
            fail(f"--remat {mode}: K1 / K2 launches {a1}, {a2}, not {2 * n_tr} / {2 * n_ol} "
                 f"forwards and {n_tr} / {n_ol} backwards")
    del grads, ref

    def timed_step(mode, b, iters=5):
        m, sb = make(mode)
        state = TrainState.create(model=m, optimizer=create_optimizer(args, m),
                                  ema_decays=sb.ema_decays)
        d = synthetic(b)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, _, _ = counted(lambda: time_call(lambda: sb.train_step(state, d, 1e-3, r=img),
                                             iters, 2, dev))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return ms, peak

    for mode, b in (("", big), ("full", big), ("dots", big), ("full", 2 * big)):
        ms, peak = timed_step(mode, b)
        say(f"phase 10 remat {mode or 'none'} train step b={b} {img}px bf16 on {card}: "
            f"{ms:.2f} ms ({b / ms * 1e3:.1f} img/s), peak {peak:.2f} GiB")

    # 3. the sparse target against the dense one: loss and the gradients of
    # the model's outputs, at the full resolution and at a stage's
    m, sb = make("", dp=0.0)
    d = synthetic(big)
    for r in (img, max(32, img * 4 // 7 // 32 * 32)):
        with torch.no_grad():
            x_cls, x_aux, bx = m(resize_bilinear(d["image"], r), train=True, bbox=bbox)
        res = {}
        for name, build in (("dense", build_token_label_target),
                            ("sparse", sparse_token_label_target)):
            # f32 leaves: the gradients of bf16 ones would be rounded to bf16
            xc = x_cls.detach().float().requires_grad_(True)
            xa = x_aux.detach().float().requires_grad_(True)
            tgt = build(d["label"], d["label_scores"], d["label_inds"], num_classes=1000,
                        smoothing=0.1, label_size=r // 16)
            loss = loss_fn((xc, xa, bx), tgt)
            res[name] = (loss.detach(), *torch.autograd.grad(loss, [xc, xa]))
        (ld, gcd, gad), (ls, gcs, gas) = res["dense"], res["sparse"]
        rel = [float((ls - ld).abs() / ld.abs())] + [
            float((s - dd).abs().max() / dd.abs().max()) for s, dd in ((gcs, gcd), (gas, gad))]
        say(f"phase 10 sparse target b={big} r={r} (token grid {r // 16}): loss sparse "
            f"{float(ls):.7f} dense {float(ld):.7f}; relative differences loss, d x_cls, "
            f"d x_aux {['%.2e' % v for v in rel]}")
        if max(rel) > 1e-4:
            fail(f"the sparse token-label target differs from the dense one at r={r}")
    del m, sb, d

    # 4. the bench's knobs: the step with each set, against none (before
    # and after)
    knobs = ("AUTOPROG_BENCH_EMA_BF16", "AUTOPROG_BENCH_MU_BF16", "AUTOPROG_SPARSE_TL")
    times = {}
    for knob in ("none",) + knobs + ("none again",):
        if knob in knobs:
            os.environ[knob] = "1"
        try:
            sbk, state, dk = bench.make_step(dev, big)
            ms = counted(lambda: bench.time_step(sbk, state, dk, 1.6e-3, r=img, iters=10,
                                                 warmup=3))[0] * 1e3
        finally:
            os.environ.pop(knob, None)
        times[knob] = ms
        del sbk, state, dk
        say(f"phase 10 bench step b={big} {img}px bf16 on {card} with {knob}"
            f"{'=1' if knob in knobs else ''}: {ms:.2f} ms ({big / ms * 1e3:.1f} img/s)")
    none = (times["none"] + times["none again"]) / 2
    say(f"phase 10 knobs against the mean of the two runs without ({none:.2f} ms): " +
        ", ".join(f"{k}=1 {100 * (times[k] / none - 1):+.1f} %" for k in knobs))

    # 5. SGD under the profiler: 4 steps, batches 1 and 2 traced
    out = tempfile.mkdtemp(prefix="chip_smoke_sgd_")
    trace_dir = os.path.join(out, "trace")
    argv = base_argv + ["--opt", "sgd", "--token-label", "--token-label-data", "synthetic",
                        "--profile", trace_dir, "--profile-steps", "2", "--fake-data-size",
                        str(4 * batch), "--output", out]
    t0 = time.time()
    counted(lambda: fixed_main.main(argv))
    run, log, losses = _trainer_log(out)
    ckpt = torch.load(os.path.join(run, "last.ckpt"), map_location="cpu", weights_only=False)
    kinds = {k for s in ckpt["optimizer"]["state"].values() for k in s}
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    busy = {}           # device microseconds by kernel name over the traced steps
    for path in traces:
        for ev in json.load(open(path)).get("traceEvents", []):
            if ev.get("cat") == "kernel":
                name = ev.get("name", "")
                n, us = busy.get(name, (0, 0.0))
                busy[name] = (n + 1, us + float(ev.get("dur", 0.0)))
    names = set(busy)
    found = {k: sorted(n for n in names if k in n)[:2]
             for k in ("mhsa_fwd", "mhsa_bwd", "outlook_fwd", "outlook_bwd")}
    say(f"phase 10 sgd: python -m autoprog_tpu_torch.main {' '.join(argv[:-2])} "
        f"({time.time() - t0:.1f} s): losses {losses}; optimizer state {sorted(kinds)}; "
        f"trace {traces} with {len(names)} kernel names, K1 / K2 among them: {found}")
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses) or \
            kinds != {"momentum_buffer"}:
        fail(f"--opt sgd: expected 4 finite losses and a momentum buffer, got {losses}, "
             f"{kinds}")
    if len(traces) != 1 or not all(found.values()):
        fail(f"--profile: no trace naming K1's and K2's kernels ({traces}, {found})")
    top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:12]
    say(f"phase 10 sgd trace, 2 steps at b={batch}: device busy "
        f"{sum(us for _, us in busy.values()) / 2e3:.2f} ms a step in "
        f"{sum(n for n, _ in busy.values()) // 2} kernels; by kernel (ms a step, launches a "
        f"step): " + "; ".join(f"{name[:90]} {us / 2e3:.2f} ({n // 2})"
                               for name, (n, us) in top))

    # 6. the per-segment times
    for b, flags in ((big, ["--loss-bisect"]), (2 * big, [])):
        t0 = time.time()
        res, line = _grab_json(lambda: counted(lambda: bench_parts.main([str(b)] + flags)))
        say(f"phase 10 python -m autoprog_tpu_torch.scripts.bench_parts {b} {' '.join(flags)} "
            f"({time.time() - t0:.1f} s): {line}")
        if not all(v > 0 for v in res["rows"].values()):
            fail(f"bench_parts at b={b}: a row without a time")
    torch.cuda.synchronize()
    return k1, k2


# ------------------------------------------------- phase 11: data parallelism

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _timed_steps(torch, state, sb, data, iters: int) -> float:
    """Wall milliseconds per step on the synchronised clock, after 2 steps."""
    from autoprog_tpu_torch.parallel import mesh
    rows = mesh.process_batch_slice(data["image"].shape[0])
    local = {k: v[rows] for k, v in data.items()}
    for _ in range(2):
        sb.train_step(state, local, 1e-3, r=224)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = sb.train_step(state, local, 1e-3, r=224)["loss"]
    torch.cuda.synchronize()
    if not math.isfinite(float(loss)):
        fail("non-finite loss in the timed steps")
    return (time.perf_counter() - t0) / iters * 1e3


def _all_reduce_ms(torch, state, iters: int = 10) -> float:
    """Milliseconds of one gradient all-reduce (every parameter's gradient,
    f32) on the synchronised clock."""
    from autoprog_tpu_torch.parallel import mesh
    params = list(state.model.parameters())
    for p in params:
        p.grad = torch.ones_like(p)
    mesh.all_reduce_grads(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        mesh.all_reduce_grads(params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    for p in params:
        p.grad = None
    return ms


def _state_digest(state) -> str:
    import hashlib
    h = hashlib.sha256()
    trees = [dict(state.model.named_parameters()), dict(state.model.named_buffers()),
             *state.ema_params]
    for tree in trees:
        for name in sorted(tree):
            h.update(name.encode())
            h.update(tree[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dist_worker(out_dir: str) -> None:
    """One rank of phase 11 (b) and (c), started by `phase_data_parallel`
    with torchrun's environment, gloo and AUTOPROG_TORCH_DEVICE=cuda:0:
    `main_prog.main` with phase 5's arguments, then the f32 step of (c) and
    the timed steps. Writes rank<r>.json (and rank 0 its step's tensors) to
    `out_dir`."""
    import torch
    from autoprog_tpu_torch import main_prog
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.prog import autogrow
    from autoprog_tpu_torch.scripts import dp_parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not mesh.maybe_init_distributed():
        fail("the worker found no torchrun environment")
    rank = mesh.process_index()
    res = {"rank": rank, "world": mesh.process_count(),
           "backend": torch.distributed.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device()))}
    with open(os.path.join(out_dir, "argv.json")) as f:
        argv = json.load(f)
    decisions = []
    sync = autogrow.sync_decision

    def recorded(r, l):
        synced = sync(r, l)
        decisions.append([[r, l], list(synced)])
        return synced
    autogrow.sync_decision = recorded
    run_dir = os.path.join(out_dir, f"out{rank}")
    os.makedirs(run_dir)
    for counts in (A.LAUNCHES, O.LAUNCHES, mesh.COUNTS):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    main_prog.main(argv + ["--output", run_dir])
    torch.cuda.synchronize()
    ctx = main_prog.LAST_CTX
    res.update(wall=time.time() - t0, decisions=decisions, arch=ctx.mdef.name,
               history=[{k: (list(map(float, v)) if isinstance(v, tuple) else v)
                         for k, v in h.items()} for h in ctx.stage_history],
               digest=_state_digest(ctx.state), k1=dict(A.LAUNCHES), k2=dict(O.LAUNCHES),
               collectives=dict(mesh.COUNTS),
               files=sorted(os.path.relpath(os.path.join(d, f), run_dir)
                            for d, _, fs in os.walk(run_dir) for f in fs))
    del ctx, main_prog.LAST_CTX
    torch.cuda.empty_cache()

    # (c) one f32 step on this rank's half of 32 images
    state, sb, data = dp_parity.setup(32, torch.float32)
    loss, grads, stats = dp_parity.dp_step(state, sb, data)
    res.update(loss=loss, step_digest=_state_digest(state))
    if rank == 0:
        torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()},
                    "stats": {k: v.cpu() for k, v in stats.items()}},
                   os.path.join(out_dir, "step_rank0.pt"))
    # (d) the 2-rank step's time and the gradient all-reduce alone, through the host
    res["step_ms"] = _timed_steps(torch, state, sb, data, 5)
    res["all_reduce_ms"] = _all_reduce_ms(torch, state, 3)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.destroy()


def _close_per_tensor(name, got, want, rtol):
    """|got - want| <= rtol * (|want| + max |want|), per tensor."""
    for k, w in want.items():
        err = (got[k].float() - w.float()).abs()
        bound = rtol * (w.float().abs() + w.float().abs().max())
        if not bool((err <= bound).all()):
            fail(f"phase 11 {name} {k}: worst error {float(err.max()):.3e} beyond rtol {rtol}")


def phase_data_parallel(torch, card, fixed_run, fixed_argv, prog_argv, batch: int = 128):
    """Phase 11: the trainers across processes (`parallel/mesh.py`).
    (d, first half) the b=128 step without a group; (a) world 1 on NCCL:
    the step under the group, the gradient all-reduce alone, then
    `main.main` with phase 4's arguments; (d) the step again without a
    group; (b, c) two gloo ranks on cuda:0 (`dist_worker`); (c) the same f32
    step in this process on all 32 images. Returns the K1 and K2 launches of
    (a) and (b)."""
    from autoprog_tpu_torch.main import main
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.parallel import mesh
    from autoprog_tpu_torch.scripts import dp_parity
    t_phase = time.time()
    for var in ("AUTOPROG_FUSED_ATTN", "AUTOPROG_FUSED_OUTLOOK", "AUTOPROG_DIST_BACKEND",
                "AUTOPROG_TORCH_DEVICE"):
        os.environ.pop(var, None)
    state, sb, data = dp_parity.setup(batch, torch.bfloat16, drop_path=0.1)
    ms = {"none": [_timed_steps(torch, state, sb, data, 10)]}

    # (a) world 1 on NCCL, the environment torchrun --standalone would set
    env = _torchrun_env(0, 1, _free_port())
    os.environ.update(env)
    if not mesh.maybe_init_distributed():
        fail("maybe_init_distributed found no group in torchrun's environment")
    backend = torch.distributed.get_backend()
    say(f"phase 11 world 1: backend {backend}, world {mesh.process_count()}, device "
        f"cuda:{torch.cuda.current_device()}")
    if backend != "nccl" or mesh.process_count() != 1:
        fail("world 1 on the card did not take NCCL")
    ms["nccl"] = [_timed_steps(torch, state, sb, data, 10)]
    out = tempfile.mkdtemp(prefix="chip_smoke_dp1_")
    for counts in (A.LAUNCHES, O.LAUNCHES, mesh.COUNTS):
        for k in counts:
            counts[k] = 0
    steps = 4
    main(fixed_argv + ["--output", out])
    torch.cuda.synchronize()
    k1_a, k2_a, coll = dict(A.LAUNCHES), dict(O.LAUNCHES), dict(mesh.COUNTS)
    _, _, losses = _trainer_log(out)
    _, _, losses4 = _trainer_log(os.path.dirname(os.path.dirname(fixed_run)))
    ms["nccl"].append(_timed_steps(torch, state, sb, data, 10))
    ar_ms = _all_reduce_ms(torch, state)
    mesh.destroy()
    for k in env:
        del os.environ[k]
    say(f"phase 11 (a) main.main on NCCL world 1, phase 4's arguments: losses {losses}; "
        f"phase 4's (no group) {losses4} ({'equal' if losses == losses4 else 'not equal'})")
    say(f"phase 11 (a) launches: K1 {k1_a}, K2 {k2_a}; collectives {coll}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"expected {steps} finite losses under NCCL world 1, got {losses}")
    if k1_a["bwd"] != 14 * steps or k1_a["fwd"] < 14 * steps or \
            k2_a["bwd"] != 4 * steps or k2_a["fwd"] < 4 * steps:
        fail(f"K1 {k1_a} / K2 {k2_a} do not cover 14 / 4 layers a step under NCCL world 1")
    if coll["grads"] != steps:
        fail(f"the gradient all-reduce ran {coll['grads']} times in {steps} steps")
    ms["none"].append(_timed_steps(torch, state, sb, data, 10))
    none, nccl = sum(ms["none"]) / 2, sum(ms["nccl"]) / 2
    say(f"phase 11 (d) volo_d1 train step b={batch} 224px bf16, drop-path 0.1, on {card}, "
        f"in the order no group, NCCL world 1, (a), NCCL world 1, no group: no group "
        f"{none:.2f} ms (runs {ms['none']}), NCCL world 1 {nccl:.2f} ms (runs "
        f"{ms['nccl']}; {100 * (nccl / none - 1):+.1f} %); the gradient all-reduce alone "
        f"(26.6 M f32 values: flatten, NCCL, copy back) {ar_ms:.3f} ms")
    del state, sb, data
    torch.cuda.empty_cache()

    # (b, c) two gloo ranks sharing cuda:0
    out = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    argv = list(prog_argv)
    argv[argv.index("--workers") + 1] = "3"
    argv.append("--model-ema-bf16")       # the EMA trees' rounding must agree across ranks
    with open(os.path.join(out, "argv.json"), "w") as f:
        json.dump(argv, f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, **_torchrun_env(rank, 2, port), AUTOPROG_DIST_BACKEND="gloo",
                   AUTOPROG_TORCH_DEVICE="cuda:0")
        with open(os.path.join(out, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--dist-worker", out], env=env,
                                          stdout=subprocess.DEVNULL, stderr=err))
    deadline = time.time() + 600
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            fail("the 2-rank run did not end within 600 s")
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            err = open(os.path.join(out, f"rank{rank}.err")).read()
            fail(f"gloo rank {rank} failed ({p.returncode}):\n{err[-4000:]}")
    res = []
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    r0, r1 = res
    log = open(glob.glob(os.path.join(out, "out0", "train", "*", "log.txt"))[0]).read()
    losses = [float(v) for v in re.findall(r"Train: \d+ \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    say(f"phase 11 (b) main_prog --auto-grow on 2 gloo ranks sharing cuda:0, global b=64: "
        f"backends {[r['backend'] for r in res]}, devices {[r['device'] for r in res]}, "
        f"{r0['wall']:.1f} s")
    say(f"phase 11 (b) decisions (proposal, adopted): rank 0 {r0['decisions']}, rank 1 "
        f"{r1['decisions']}; stages {[(h['r'], h['l']) for h in r0['history']]}")
    say(f"phase 11 (b) losses (rank 0's log): {losses}")
    for r in res:
        say(f"phase 11 (b) rank {r['rank']}: K1 {r['k1']}, K2 {r['k2']}, collectives "
            f"{r['collectives']}, files {len(r['files'])}")
    if any(r["backend"] != "gloo" or r["device"] != "cuda:0" or r["world"] != 2 for r in res):
        fail("the 2-rank run was not gloo on cuda:0")
    if len(r0["decisions"]) != 1 or r0["decisions"][0][1] != r0["decisions"][0][0] or \
            r1["decisions"][0][1] != r0["decisions"][0][0]:
        fail("the ranks did not both adopt rank 0's decision")
    if r0["history"] != r1["history"] or (r0["history"][-1]["r"], r0["history"][-1]["l"]) \
            != (224, 18) or r0["arch"] != r1["arch"]:
        fail("the ranks' stage histories differ or do not end at r=224, l=18")
    if r0["digest"] != r1["digest"]:
        fail("the ranks' parameters, BatchNorm stats or EMA trees are not bit-equal")
    if len(losses) != 15 or not all(math.isfinite(v) for v in losses):
        fail(f"expected 15 finite losses after the search, got {losses}")
    for r in res:
        if r["k1"]["bwd"] <= 0 or r["k1"]["fwd"] <= 0 or r["k2"]["bwd"] <= 0 or \
                r["k2"]["fwd"] <= 0:
            fail(f"rank {r['rank']} launched no K1 or K2: {r['k1']} {r['k2']}")
        if r["collectives"]["grads"] != 20:
            fail(f"rank {r['rank']}: {r['collectives']['grads']} gradient all-reduces in "
                 f"20 train steps")
    if r0["k1"] != r1["k1"] or r0["k2"] != r1["k2"]:
        fail("the ranks launched K1 / K2 different numbers of times")
    if "last.ckpt" not in {os.path.basename(f) for f in r0["files"]} or r1["files"]:
        fail("checkpoints were not written by rank 0 alone")

    # (c) the one-process step on all 32 images against the 2-rank one
    state, sb, data = dp_parity.setup(32, torch.float32)
    loss, grads, stats = dp_parity.dp_step(state, sb, data)
    one_ms = _timed_steps(torch, state, sb, data, 5)
    two = torch.load(os.path.join(out, "step_rank0.pt"))
    rel = abs(two["loss"] - loss) / abs(loss)
    say(f"phase 11 (c) volo_d1 f32 step, 32 images: loss one process {loss:.7f}, 2 gloo "
        f"ranks {two['loss']:.7f} (rel {rel:.2e}); rank 1's state "
        f"{'bit-equal' if r0['step_digest'] == r1['step_digest'] else 'NOT equal'} to rank 0's")
    if rel > 1e-4 or r0["step_digest"] != r1["step_digest"]:
        fail("the 2-rank f32 step's loss or state does not match")
    _close_per_tensor("BatchNorm stat", two["stats"], {k: v.cpu() for k, v in stats.items()},
                      1e-4)
    total, per = dp_parity.grad_errors(two["grads"], grads)
    stem, rest = dp_parity.worst(per, True), dp_parity.worst(per, False)
    lim_all, lim_stem = dp_parity.RTOL_ALL, dp_parity.RTOL_STEM
    say(f"phase 11 (c) the {len(grads)} all-reduced gradients against the one-process step: "
        f"|g2 - g1| / |g1| over all of them {total:.2e} ({lim_all} allowed); worst stem "
        f"tensor {stem[0]} {stem[1]:.2e} ({lim_stem} allowed: its gradient comes through "
        f"BatchNorm's backward, whose sums over 401 408 values a channel cancel); worst other "
        f"tensor {rest[0]} {rest[1]:.2e} ({lim_all} allowed); the {len(stats)} BatchNorm "
        f"stats within |err| <= 1e-4 (|x| + max |x|)")
    if total > lim_all or stem[1] > lim_stem or rest[1] > lim_all:
        fail("the 2-rank step's gradients do not match the one-process step's")
    say(f"phase 11 (d) f32 step b=32 on {card}: one process {one_ms:.2f} ms; two ranks "
        f"sharing one card through the host (gloo), not a data-parallel speed: "
        f"{r0['step_ms']:.2f} / {r1['step_ms']:.2f} ms, of which the gradient all-reduce "
        f"alone {r0['all_reduce_ms']:.2f} ms")
    say(f"phase 11: {time.time() - t_phase:.1f} s")
    del state, sb, data
    torch.cuda.empty_cache()
    k1 = {s: k1_a[s] + r0["k1"][s] + r1["k1"][s] for s in ("fwd", "bwd")}
    k2 = {s: k2_a[s] + r0["k2"][s] + r1["k2"][s] for s in ("fwd", "bwd")}
    return k1, k2


# ---------------------------------------------- phase 12: tensor parallelism

TP_STEPS = 3
#: phase 12 (c)'s global batch, train steps an epoch, and its search's probe
#: batches and timed steps a candidate (phase 5: 64, 5, 3 and 3): cut so that
#: the gloo round trips of the trainer and its resume, whose activations are
#: all-reduced through the host, stay within the phase's time
TP_PROG_CUTS = {"-b": 16, "--fake-data-size": 2, "--search-probe-steps": 1,
                "--search-time-iters": 1}
TP_VALIDATE = ["synthetic://", "--num-classes", "1000", "--img-size", "224", "-b", "16",
               "--workers", "0", "--fake-data-size", "70", "--no-bf16"]
#: phase 12 (f): volo_d4's widths at depth 4 (2 outlookers at 384 on 12 heads,
#: 2 transformers at 768 on 16), two legs of options with what each records
#: per f32 step, and their launches per step and rank (K1 on a transformer
#: layer, K2 on an outlooker; leg A: 2 micro-batches, and `--remat dots`
#: runs each forward again in the backward)
TP_LEG_MODEL = "volod4_h16_l4"
TP_LEG_STEPS = 2
TP_LEGS = {"A": dict(opt="sgd", splits=2, remat="dots", drop_path=0.1, sparse=True,
                     keys=("grads", "params")),
           "B": dict(mu_bf16=True, ema_bf16=True, opt_eps=1e-3,
                     keys=("grads", "params", "opt", "ema"))}
TP_LEG_LAUNCHES = {"A": {"fwd": 2 * 2 * 2, "bwd": 2 * 2}, "B": {"fwd": 2, "bwd": 2}}


def _replicated_digest(state) -> str:
    """sha256 of the leaves every rank of a model group holds whole: the
    replicated parameters and EMA leaves, and the buffers."""
    import hashlib
    from autoprog_tpu_torch.parallel.tp import param_spec
    h = hashlib.sha256()
    trees = [dict(state.model.named_parameters()), dict(state.model.named_buffers()),
             *state.ema_params]
    for tree in trees:
        for name in sorted(tree):
            if param_spec(name, tree[name].ndim) is None:
                h.update(name.encode())
                h.update(tree[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_logits(torch, dtype, images, fused: bool):
    """volo_d1 eval logits (parameters from seed 0) on `images`, with K1
    and K2 on or both off; under the grid, this rank's shards."""
    from autoprog_tpu_torch.scripts import dp_parity
    os.environ["AUTOPROG_FUSED_ATTN"] = os.environ["AUTOPROG_FUSED_OUTLOOK"] = \
        "1" if fused else "0"
    try:
        state, _, _ = dp_parity.setup(1, dtype)
        with torch.no_grad():
            out = state.model(images, train=False).float()
        torch.cuda.synchronize()
    finally:
        del os.environ["AUTOPROG_FUSED_ATTN"], os.environ["AUTOPROG_FUSED_OUTLOOK"]
    return out.cpu()


def _same_file_state(torch, ctx, ck) -> list:
    """The names whose gathered tensors differ from the checkpoint's (a
    collective over the model group under tensor parallelism)."""
    from autoprog_tpu_torch.parallel import tp
    bad = [n for n, t in tp.gather_local(ctx.state.params).items()
           if not torch.equal(t.detach().cpu(), ck["state_dict"][n])]
    for i, tree in enumerate(ctx.state.ema_params):
        bad += [f"ema{i}.{n}" for n, t in tp.gather_local(tree).items()
                if not torch.equal(t.cpu(), ck[f"state_dict_ema_{i}"][n])]
    return bad


def _tp_leg(torch, leg: str, dtype, steps: int):
    """Phase 12 (f): `steps` of leg `leg` of TP_LEGS on TP_LEG_MODEL at b=8
    (`dp_parity.setup`'s parameters and batch under the leg's options),
    recorded by `tp_parity.leg_steps` (in f32 what the leg keeps, gathered
    over the model group; in bf16 the loss)."""
    from autoprog_tpu_torch.scripts import dp_parity, tp_parity
    opts = dict(TP_LEGS[leg])
    splits, sparse, keys = opts.pop("splits", 1), opts.pop("sparse", False), opts.pop("keys")
    state, sb, data = dp_parity.setup(8, dtype, model=TP_LEG_MODEL,
                                      bias_std=tp_parity.BIAS_STD, **opts)
    rec = tp_parity.leg_steps(state, sb, [data] * steps, img_size=224,
                              bbox=dp_parity.box(224), splits=splits, sparse=sparse,
                              keys=keys if dtype == torch.float32 else ())
    del state, sb, data
    torch.cuda.empty_cache()
    return rec


def _check_tp_legs(two, ref, res, ref_f_s) -> None:
    """Phase 12 (f): each leg's records at M = 2 (rank 0's, `two`) against
    this process's (`ref`), and each rank's bf16 losses and launches
    (`res`); prints a line a leg and a rank and fails beyond a limit."""
    from autoprog_tpu_torch.scripts import tp_parity
    for leg in TP_LEGS:
        got, want = two["f_" + leg], ref["f_" + leg]
        rows = [tp_parity.compare(g["loss"], g["grads"], w["loss"], w["grads"], leg, step)
                for step, (g, w) in enumerate(zip(got, want))]
        fam = " | ".join(f"step {r['seed'] + 1}: loss rel {r['loss_rel']:.2e}, all "
                         f"{r['grad_total']:.2e}, " +
                         ", ".join(f"{f} {r['worst'][f][1]:.2e}" for f in tp_parity.FAMILIES)
                         for r in rows)
        at = len(got) - 1 if leg == "A" else 0     # leg B's bf16 moment: after step 1
        dp = max(float((got[at]["params"][k] - w).abs().max())
                 for k, w in want[at]["params"].items())
        line = (f"phase 12 (f) leg {leg} {TP_LEGS[leg]} on {TP_LEG_MODEL} at 224 px, global "
                f"batch 8, {len(got)} f32 steps, M=2 against one process, worst per leaf "
                f"family: {fam}; parameters after step {at + 1} within {dp:.2e} (tol 1e-6)")
        bad = [r["seed"] + 1 for r in rows if not r["within"]]
        if leg == "B":
            mu = tp_parity.mu_bf16_bounds(got, want, lr=1e-3, eps=1e-3)
            ema = tp_parity.ema_bf16_steps(got[-1]["ema"], want[-1]["ema"])
            line += (f"; bf16 first moment: {mu['m1']} / {mu['m2']} of {mu['elements']} "
                     f"elements differ after steps 1 / 2, parameters after step 2 within "
                     f"{mu['dp']:.2e} (per-element bound at most {mu['bound']:.2e}, beyond it: "
                     f"{mu['beyond']}); bf16 EMA (4 trees): {ema['differ']} of "
                     f"{ema['elements']} elements differ, at most {ema['max_steps']} bf16 "
                     f"step")
            if mu["beyond"] or ema["max_steps"] > 1:
                bad.append("bf16 states")
        say(line)
        if bad or dp > 1e-6:
            fail(f"phase 12 (f) leg {leg} under --model-parallel 2 is beyond its limits: "
                 f"{bad}, parameters {dp:.2e}")
    n = TP_LEG_STEPS + 1
    want_k = {s: n * sum(c[s] for c in TP_LEG_LAUNCHES.values()) for s in ("fwd", "bwd")}
    for r in res:
        say(f"phase 12 (f) rank {r['rank']}: {r['f_s']:.1f} s for both legs' f32 and bf16 "
            f"steps (this process's references: {ref_f_s:.1f} s); bf16 losses "
            f"{r['f_bf16_loss']}; K1 {r['f_k1']} by (side, tokens, heads, head_dim) "
            f"{r['f_k1_shapes']}, K2 {r['f_k2']}, routes {r['f_k2_routes']}")
        if not all(math.isfinite(v) for v in r["f_bf16_loss"].values()):
            fail("phase 12 (f): a bf16 step of the options is not finite")
        if r["f_k1_shapes"] != {f"{s} 196 8 48": want_k[s] for s in ("fwd", "bwd")} or \
                r["f_k2_routes"] != {"fwd_rows": want_k["fwd"], "fwd_general": 0,
                                     "bwd_rows": want_k["bwd"], "bwd_general": 0}:
            fail(f"phase 12 (f): K1 not on 8 local heads at head_dim 48 or K2 not on its row "
                 f"kernels as often as the legs' layers ask ({want_k} a side)")


def _tp_steps(torch, res, saved) -> None:
    """Phase 12 (a), (b), (d) and (f) on this rank (see `tp_worker`)."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.scripts import dp_parity, tp_parity

    # (a) the f32 volo_d1 step on 32 images, clean and with each planted fault
    for plant in ("none",) + tp_parity.PLANTS:
        state, sb, data = dp_parity.setup(32, torch.float32, bias_std=tp_parity.BIAS_STD)
        with tp_parity.planted(plant):
            loss, grads, _ = tp_parity.tp_step(state, sb, data)
        saved[plant] = {"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()}}
        del state, sb, data, grads

    # (b) the kernels on the local heads: bf16 steps at b=64 with K1 and K2
    # on, then with both off; the eval logits at f32 and bf16
    for counts in (A.LAUNCHES, O.LAUNCHES, O.ROUTES):
        for k in counts:
            counts[k] = 0
    A.SHAPE_LAUNCHES.clear()
    state, sb, data = dp_parity.setup(64, torch.bfloat16, drop_path=0.1)
    ms = {}
    for fused in (True, False):
        if not fused:
            os.environ["AUTOPROG_FUSED_ATTN"] = os.environ["AUTOPROG_FUSED_OUTLOOK"] = "0"
            on = (dict(A.LAUNCHES), dict(O.LAUNCHES),
                  {" ".join(map(str, k)): c for k, c in A.SHAPE_LAUNCHES.items()},
                  {s: O.PLANS[s] for s in ("fwd", "bwd")}, dict(O.ROUTES))
        sb.train_step(state, data, 1e-3, r=224)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            loss = sb.train_step(state, data, 1e-3, r=224)["loss"]
        torch.cuda.synchronize()
        ms["on" if fused else "off"] = (time.perf_counter() - t0) / TP_STEPS * 1e3
        if not math.isfinite(float(loss)):
            fail("non-finite loss in the bf16 tensor-parallel steps")
    del os.environ["AUTOPROG_FUSED_ATTN"], os.environ["AUTOPROG_FUSED_OUTLOOK"]
    res.update(step_ms=ms, k1=on[0], k2=on[1], k1_shapes=on[2], k2_plans=on[3],
               k2_routes=on[4], k1_after_off=dict(A.LAUNCHES), k2_after_off=dict(O.LAUNCHES))
    del state, sb, data
    torch.cuda.empty_cache()
    images = torch.randn(8, 224, 224, 3, generator=torch.Generator().manual_seed(5)).cuda()
    saved["logits"] = {"f32_on": _tp_logits(torch, torch.float32, images, True),
                       "f32_off": _tp_logits(torch, torch.float32, images, False),
                       "bf16_on": _tp_logits(torch, torch.bfloat16, images, True)}

    # (d) volo_d4 (768 wide, 16 heads): the f32 step at b=8, one bf16 step
    state, sb, data = dp_parity.setup(8, torch.float32, model="volo_d4",
                                      bias_std=tp_parity.BIAS_STD)
    loss, grads, _ = tp_parity.tp_step(state, sb, data)
    saved["d4"] = {"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()}}
    del state, sb, data, grads
    A.SHAPE_LAUNCHES.clear()
    state, sb, data = dp_parity.setup(8, torch.bfloat16, model="volo_d4")
    res["d4_bf16_loss"] = dp_parity.dp_step(state, sb, data)[0]
    res["d4_k1_shapes"] = {" ".join(map(str, k)): c for k, c in A.SHAPE_LAUNCHES.items()}
    del state, sb, data
    torch.cuda.empty_cache()

    # (f) the step's options on volo_d4's widths
    _tp_legs(torch, res, saved)


def _tp_legs(torch, res, saved) -> None:
    """Phase 12 (f) on this rank: each leg's f32 steps (their records into
    `saved`), then one bf16 step; the launches of all of them are (f)'s on
    the main path (into `res`)."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    for counts in (A.LAUNCHES, O.LAUNCHES, O.ROUTES):
        for k in counts:
            counts[k] = 0
    A.SHAPE_LAUNCHES.clear()
    t0 = time.time()
    res["f_bf16_loss"] = {}
    for leg in TP_LEGS:
        rec = _tp_leg(torch, leg, torch.float32, TP_LEG_STEPS)
        for step in rec:       # what `_check_tp_legs` reads: the last EMA trees, no nu
            if step is not rec[-1]:
                step.pop("ema", None)
            for st in step.get("opt", {}).values():
                st.pop("exp_avg_sq", None)
        saved["f_" + leg] = rec
        res["f_bf16_loss"][leg] = _tp_leg(torch, leg, torch.bfloat16, 1)[0]["loss"]
    torch.cuda.synchronize()
    res.update(f_s=time.time() - t0, f_k1=dict(A.LAUNCHES), f_k2=dict(O.LAUNCHES),
               f_k2_routes=dict(O.ROUTES),
               f_k1_shapes={" ".join(map(str, k)): c for k, c in A.SHAPE_LAUNCHES.items()})


def _tp_trainer(torch, out_dir, rank, res) -> None:
    """Phase 12 (c) and (e) on this rank (see `tp_worker`)."""
    from autoprog_tpu_torch import main_prog, validate
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.parallel import mesh, tp
    from autoprog_tpu_torch.prog import autogrow
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    with open(os.path.join(out_dir, "argv.json")) as f:
        argv = json.load(f)

    # (c) the progressive trainer through a grow boundary, then a resume at M = 2
    decisions = []
    sync = autogrow.sync_decision

    def recorded(r, l):
        synced = sync(r, l)
        decisions.append([[r, l], list(synced)])
        return synced
    autogrow.sync_decision = recorded
    run_dir = os.path.join(out_dir, f"out{rank}")
    os.makedirs(run_dir)
    for counts in (A.LAUNCHES, O.LAUNCHES, tp.COUNTS):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    main_prog.main(argv + ["--model-parallel", "2", "--output", run_dir])
    torch.cuda.synchronize()
    ctx = main_prog.LAST_CTX
    res.update(prog_wall=time.time() - t0, decisions=decisions, final_step=ctx.state.step,
               history=[[h["r"], h["l"]] for h in ctx.stage_history],
               digest=_replicated_digest(ctx.state), prog_k1=dict(A.LAUNCHES),
               prog_k2=dict(O.LAUNCHES), tp_counts=dict(tp.COUNTS),
               files=sorted(os.path.relpath(os.path.join(d, f), run_dir)
                            for d, _, fs in os.walk(run_dir) for f in fs))
    autogrow.sync_decision = sync
    del ctx, main_prog.LAST_CTX
    mesh.barrier("files")
    if rank == 0:                     # the checkpoints are whole: the parent may read them
        open(os.path.join(out_dir, "trained"), "w").close()
    run0 = glob.glob(os.path.join(out_dir, "out0", "train", "*"))[0]
    snap = os.path.join(run0, "checkpoint-2.ckpt")
    ck = load_checkpoint_file(snap)
    differ = []
    restore = _first_epoch_hook(lambda ctx, e: differ.extend(_same_file_state(torch, ctx, ck)))
    resume_dir = os.path.join(out_dir, f"resume{rank}")
    os.makedirs(resume_dir)
    try:
        main_prog.main(argv + ["--model-parallel", "2", "--resume", snap, "--output",
                               resume_dir])
    finally:
        restore()
    res.update(resume_differ=differ, resume_step=main_prog.LAST_CTX.state.step)
    del main_prog.LAST_CTX, ck
    torch.cuda.empty_cache()

    # (e) the validator over both ranks (data parallel: the grid back to M = 1)
    mesh.init_grid(1)
    best = os.path.join(run0, "model_best.ckpt")
    res["validate"] = validate.main(TP_VALIDATE + ["--checkpoint", best])[0]


def tp_worker(out_dir: str, role: str) -> None:
    """One rank of phase 12, started by `phase_tensor_parallel` with
    torchrun's environment, gloo and AUTOPROG_TORCH_DEVICE=cuda:0, on a
    (data 1 x model 2) grid. Two such worlds run side by side: role `steps`
    takes (a), (b), (d) and (f), role `trainer` (c) and (e). Writes
    <role><r>.json and rank 0's tensors to `out_dir`."""
    import torch
    from autoprog_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not mesh.maybe_init_distributed():
        fail("the worker found no torchrun environment")
    mesh.init_grid(2)
    rank = mesh.process_index()
    t0 = time.time()
    res = {"rank": rank, "grid": [mesh.data_count(), mesh.model_count()],
           "backend": torch.distributed.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device()))}
    if role == "steps":
        saved = {}
        _tp_steps(torch, res, saved)
        if rank == 0:
            torch.save(saved, os.path.join(out_dir, "steps0.pt"))
    else:
        _tp_trainer(torch, out_dir, rank, res)
    res["wall_s"] = time.time() - t0
    with open(os.path.join(out_dir, f"{role}{rank}.json"), "w") as f:
        json.dump(res, f, default=float)
    mesh.destroy()


def _ckpt_layout(ck) -> dict:
    """The keys and shapes of a checkpoint's tensors."""
    out = {}
    for key in ("state_dict", "batch_stats", *[f"state_dict_ema_{i}" for i in range(4)]):
        out.update({f"{key}.{n}": tuple(t.shape) for n, t in ck[key].items()})
    for i, st in ck["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": tuple(v.shape) for k, v in st.items()})
    return out


def phase_tensor_parallel(torch, card, prog_run, prog_argv):
    """Phase 12: `--model-parallel 2` (`parallel/tp.py`) as two worlds of two
    gloo ranks each, side by side on cuda:0 (`tp_worker`: the steps of (a),
    (b), (d), (f) and the trainer of (c), (e)), against this process on the same
    card. Returns the K1 and K2 launches of (c) and (f) on both ranks."""
    from autoprog_tpu_torch import main_prog, validate
    from autoprog_tpu_torch.scripts import dp_parity, tp_parity
    from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
    t_phase = time.time()
    for var in ("AUTOPROG_FUSED_ATTN", "AUTOPROG_FUSED_OUTLOOK", "AUTOPROG_DIST_BACKEND",
                "AUTOPROG_TORCH_DEVICE"):
        os.environ.pop(var, None)
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    argv = list(prog_argv)
    argv[argv.index("--workers") + 1] = "3"
    for flag, n in TP_PROG_CUTS.items():
        batches = int(argv[argv.index("-b") + 1]) if flag == "--fake-data-size" else 1
        argv[argv.index(flag) + 1] = str(n * batches)
    with open(os.path.join(out, "argv.json"), "w") as f:
        json.dump(argv, f)
    procs = []
    for role in ("trainer", "steps"):            # two worlds side by side on the card
        port = _free_port()
        for rank in range(2):
            env = dict(os.environ, **_torchrun_env(rank, 2, port),
                       AUTOPROG_DIST_BACKEND="gloo", AUTOPROG_TORCH_DEVICE="cuda:0")
            with open(os.path.join(out, f"{role}{rank}.err"), "w") as err:
                procs.append((role, rank, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--tp-worker", out, role],
                    env=env, stdout=subprocess.DEVNULL, stderr=err)))
    deadline = time.time() + 600

    def check_exit(p, role, rank):
        if p.returncode not in (None, 0):
            err = open(os.path.join(out, f"{role}{rank}.err")).read()
            fail(f"tensor-parallel {role} rank {rank} failed ({p.returncode}):\n"
                 f"{err[-4000:]}")

    try:
        # the one-process references, on the same card while the ranks run
        ref = {}
        state, sb, data = dp_parity.setup(32, torch.float32, bias_std=tp_parity.BIAS_STD)
        loss, grads, _ = dp_parity.dp_step(state, sb, data)
        ref["none"] = (loss, {k: v.cpu() for k, v in grads.items()})
        del state, sb, data, grads
        images = torch.randn(8, 224, 224, 3, generator=torch.Generator().manual_seed(5)).cuda()
        ref["f32_on"] = _tp_logits(torch, torch.float32, images, True)
        ref["bf16_on"] = _tp_logits(torch, torch.bfloat16, images, True)
        state, sb, data = dp_parity.setup(8, torch.float32, model="volo_d4",
                                          bias_std=tp_parity.BIAS_STD)
        loss, grads, _ = dp_parity.dp_step(state, sb, data)
        ref["d4"] = (loss, {k: v.cpu() for k, v in grads.items()})
        del state, sb, data, grads
        torch.cuda.empty_cache()
        t_f = time.time()
        for leg in TP_LEGS:
            ref["f_" + leg] = _tp_leg(torch, leg, torch.float32, TP_LEG_STEPS)
        torch.cuda.synchronize()
        ref_f_s = time.time() - t_f

        # (c, e) at M = 1 once the trainer's checkpoints are whole, while its
        # ranks resume at M = 2
        while not os.path.exists(os.path.join(out, "trained")):
            for role, rank, p in procs:
                p.poll()
                check_exit(p, role, rank)
            if time.time() > deadline:
                fail("the tensor-parallel trainer did not end within 600 s")
            time.sleep(1)
        run0 = glob.glob(os.path.join(out, "out0", "train", "*"))[0]
        snap = os.path.join(run0, "checkpoint-2.ckpt")
        ck = load_checkpoint_file(snap)
        differ = []
        restore = _first_epoch_hook(lambda ctx, e: differ.extend(_same_file_state(torch, ctx, ck)))
        one = tempfile.mkdtemp(prefix="chip_smoke_tp_resume_")
        try:
            main_prog.main(argv + ["--resume", snap, "--output", one])
        finally:
            restore()
        step1 = main_prog.LAST_CTX.state.step
        del main_prog.LAST_CTX, ck
        one_v = validate.main(TP_VALIDATE + ["--checkpoint", os.path.join(run0,
                                                                           "model_best.ckpt")])[0]
        for role, rank, p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                fail("the tensor-parallel ranks did not end within 600 s")
            check_exit(p, role, rank)
    finally:                                     # no rank outlives the phase
        for _, _, q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    res, tr = [], []
    for rank in range(2):
        with open(os.path.join(out, f"steps{rank}.json")) as f:
            res.append(json.load(f))
        with open(os.path.join(out, f"trainer{rank}.json")) as f:
            tr.append(json.load(f))
    two = torch.load(os.path.join(out, "steps0.pt"))
    if any(r["backend"] != "gloo" or r["device"] != "cuda:0" or r["grid"] != [1, 2]
           for r in res + tr):
        fail("the tensor-parallel runs were not gloo on cuda:0 over a (1 x 2) grid")

    # (a) the f32 step against this process's, clean and with the faults
    for plant in ("none",) + tp_parity.PLANTS:
        row = tp_parity.compare(two[plant]["loss"], two[plant]["grads"], *ref["none"],
                                plant, 0)
        fam = "; ".join(f"{f} {row['worst'][f][0]} {row['worst'][f][1]:.2e}"
                        for f in tp_parity.FAMILIES)
        say(f"phase 12 (a) volo_d1 f32 step, 32 images, M=2 against one process, {plant}: "
            f"loss {row['loss_one']:.7f} / {row['loss_two']:.7f} (rel {row['loss_rel']:.2e}); "
            f"gradients over all {row['grad_total']:.2e}; worst per family: {fam}; "
            f"{'within' if row['within'] else 'BEYOND'} tp_parity's limits (loss "
            f"{tp_parity.RTOL_LOSS}, all {tp_parity.RTOL_ALL}, leaf {tp_parity.RTOL_LEAF}, stem "
            f"{tp_parity.RTOL_STEM})")
        if row["within"] != (plant == "none"):
            fail(f"phase 12 (a) {plant}: the limits do not tell the clean step from the faults")

    # (b) the kernels on the local heads
    r0, r1 = res
    say(f"phase 12 (b) volo_d1 bf16 b=64, drop-path 0.1, {TP_STEPS + 1} steps with K1 and K2 "
        f"on a rank: K1 {r0['k1']} by (side, tokens, heads, head_dim) {r0['k1_shapes']}, K2 "
        f"{r0['k2']}, routes {r0['k2_routes']}, last plans {r0['k2_plans']}; with both off "
        f"after: K1 {r0['k1_after_off']}, K2 {r0['k2_after_off']}")
    n = TP_STEPS + 1
    for r in res:
        plans = r["k2_plans"].values()
        if r["k1_shapes"] != {"fwd 196 6 32": 14 * n, "bwd 196 6 32": 14 * n} or \
                r["k2_routes"] != {"fwd_rows": 4 * n, "fwd_general": 0, "bwd_rows": 4 * n,
                                   "bwd_general": 0} or \
                any(p["heads"] != 3 or 3 % p["heads_per_block"] for p in plans):
            fail(f"rank {r['rank']} did not launch K1 on 6 heads and K2's row kernels on 3 "
                 f"heads once a layer: {r['k1_shapes']} {r['k2_routes']} {r['k2_plans']}")
        if r["k1_after_off"] != r["k1"] or r["k2_after_off"] != r["k2"]:
            fail("K1 or K2 ran with AUTOPROG_FUSED_ATTN=0 and AUTOPROG_FUSED_OUTLOOK=0")
    lg = two["logits"]
    e_fused = _err(lg["f32_on"], lg["f32_off"])
    e_f32 = _err(lg["f32_on"], ref["f32_on"])
    e_one = _err(ref["bf16_on"], ref["f32_on"])
    e_tp = _err(lg["bf16_on"], ref["bf16_on"])
    say(f"phase 12 (b) volo_d1 eval logits, 8 images, |logits| max "
        f"{ref['f32_on'].abs().max().item():.3f}: f32 M=2 with K1 + K2 against M=2 unfused "
        f"{e_fused:.3e} (tol 1e-3); f32 M=2 against one process {e_f32:.3e} (tol 1e-3); bf16 "
        f"M=2 against one process, K1 + K2 on both {e_tp:.3e} (tol 3 x {e_one:.3e}, the one-"
        f"process bf16 logits' distance from the f32 ones)")
    if not (e_fused <= 1e-3 and e_f32 <= 1e-3):
        fail("the f32 tensor-parallel logits through K1 / K2 disagree")
    if not (math.isfinite(e_tp) and e_tp <= 3 * e_one):
        fail("the bf16 tensor-parallel logits are further from one process's than the "
             "row-parallel reduce's roundings allow")
    for r in res:
        say(f"phase 12 (b) rank {r['rank']}: volo_d1 bf16 step b=64 as 2 gloo ranks sharing "
            f"one card through the host ({card}), beside (c)'s two ranks: "
            f"{r['step_ms']['on']:.1f} ms with K1 + K2, {r['step_ms']['off']:.1f} ms without: "
            f"gloo on one card, not a tensor-parallel speed")

    # (d) volo_d4
    row = tp_parity.compare(two["d4"]["loss"], two["d4"]["grads"], *ref["d4"], "none", 0)
    fam = "; ".join(f"{f} {row['worst'][f][1]:.2e}" for f in tp_parity.FAMILIES)
    say(f"phase 12 (d) volo_d4 224px f32 step, global batch 8 (cut from 1024: one card), M=2 "
        f"against one process: loss rel {row['loss_rel']:.2e}, gradients over all "
        f"{row['grad_total']:.2e}, worst per family {fam}; bf16 step loss "
        f"{r0['d4_bf16_loss']:.4f}, K1 launches by (side, tokens, heads, head_dim) "
        f"{r0['d4_k1_shapes']}")
    if not row["within"]:
        fail("the volo_d4 tensor-parallel step is beyond tp_parity's limits")
    if not math.isfinite(r0["d4_bf16_loss"]) or \
            r0["d4_k1_shapes"].get("bwd 196 8 48") != 28:
        fail("the volo_d4 bf16 step did not run K1 at head_dim 48 in its 28 transformer "
             "layers")

    # (f) the step's options on volo_d4's widths
    _check_tp_legs(two, ref, res, ref_f_s)
    say(f"phase 12 (f) worker walls: steps {[r['wall_s'] for r in res]}, trainer "
        f"{[r['wall_s'] for r in tr]} s")

    # (c) the progressive trainer and its checkpoint, resumed at M = 2 and M = 1
    r0, r1 = tr
    log = open(glob.glob(os.path.join(out, "out0", "train", "*", "log.txt"))[0]).read()
    losses = [float(v) for v in re.findall(r"Train: \d+ \[\s*\d+/\d+\]\s+Loss: (\S+)", log)]
    say(f"phase 12 (c) main_prog --auto-grow --model-parallel 2, phase 5's arguments but "
        f"batch {TP_PROG_CUTS['-b']}, "
        f"{TP_PROG_CUTS['--fake-data-size']} steps an epoch and the search's probes cut to "
        f"{TP_PROG_CUTS['--search-probe-steps']} batch and "
        f"{TP_PROG_CUTS['--search-time-iters']} timed step: "
        f"{r0['prog_wall']:.1f} s; decisions (proposal, adopted) {r0['decisions']} / "
        f"{r1['decisions']}; stages {r0['history']}; losses {losses}; K1 {r0['prog_k1']}, K2 "
        f"{r0['prog_k2']} on rank 0; collectives of parallel/tp.py {r0['tp_counts']}")
    if len(r0["decisions"]) != 1 or r1["decisions"][0][1] != r0["decisions"][0][0] or \
            r0["history"] != r1["history"] or r0["history"][-1] != [224, 18]:
        fail("the ranks did not follow one decision to r=224, l=18")
    if r0["digest"] != r1["digest"]:
        fail("the replicated leaves are not bit-equal across the model group")
    steps = 3 * TP_PROG_CUTS["--fake-data-size"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"expected {steps} finite losses after the search, got {losses}")
    if r1["files"] or "last.ckpt" not in {os.path.basename(f) for f in r0["files"]}:
        fail("checkpoints were not written by rank 0 alone")
    mine = load_checkpoint_file(os.path.join(run0, "last.ckpt"))
    theirs = load_checkpoint_file(os.path.join(prog_run, "last.ckpt"))
    if _ckpt_layout(mine) != _ckpt_layout(theirs) or mine["arch"] != theirs["arch"]:
        fail("the tensor-parallel checkpoint has not the keys and shapes of phase 5's")
    del mine, theirs
    say(f"phase 12 (c) checkpoint-2.ckpt resumed: at M=2 {len(r0['resume_differ'])} / "
        f"{len(r1['resume_differ'])} tensors differ from the file, final step "
        f"{r0['resume_step']}; at M=1 {len(differ)} differ, final step {step1}; unbroken run "
        f"{r0['final_step']}")
    if r0["resume_differ"] or r1["resume_differ"] or differ or \
            not r0["resume_step"] == r1["resume_step"] == step1 == r0["final_step"]:
        fail("a resume of the tensor-parallel checkpoint did not restore its state")

    # (e) the validator over two ranks against one process
    say(f"phase 12 (e) validate.py on 70 images at -b 16: 2 ranks {r0['validate']['top1']} / "
        f"{r0['validate']['top5']} (loss {r0['validate']['loss']:.7f}); one process "
        f"{one_v['top1']} / {one_v['top5']} (loss {one_v['loss']:.7f})")
    for r in tr:
        v = r["validate"]
        if (v["top1"], v["top5"], v["count"]) != (one_v["top1"], one_v["top5"], 70) or \
                abs(v["loss"] - one_v["loss"]) > 1e-5 * abs(one_v["loss"]):
            fail("validate.py over two ranks does not equal one process")
    say(f"phase 12: {time.time() - t_phase:.1f} s")
    k1 = {s: sum(r["prog_k1"][s] for r in tr) + sum(r["f_k1"][s] for r in res)
          for s in ("fwd", "bwd")}
    k2 = {s: sum(r["prog_k2"][s] for r in tr) + sum(r["f_k2"][s] for r in res)
          for s in ("fwd", "bwd")}
    return k1, k2


def _run_module(name: str, args, timeout: int, phase: int):
    """`python -m autoprog_tpu_torch.scripts.<name> <args>` in a process of
    its own (this one holds a CUDA context, and the loader spawns workers),
    with the environment of a user's shell: none of the port's switches
    that earlier phases set, no torchrun variables. The last lines of its
    stderr are echoed. Fails on a nonzero exit."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("AUTOPROG_") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    cmd = [sys.executable, "-m", f"autoprog_tpu_torch.scripts.{name}", *map(str, args)]
    t0 = time.time()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(cmd[2:])} ran past {timeout} s")
    for line in res.stderr.strip().splitlines()[-20:]:
        say(f"  | {line}")
    if res.returncode != 0:
        fail(f"{' '.join(cmd[2:])} exited {res.returncode}:\n{res.stderr[-3000:]}")
    say(f"phase {phase} python -m autoprog_tpu_torch.scripts.{name} "
        f"{' '.join(map(str, args))}: {time.time() - t0:.1f} s")
    return res


def _run_script(name: str, args, timeout: int):
    """A measurement script run by `_run_module`; its last stdout line (one
    JSON object) parsed."""
    lines = _run_module(name, args, timeout, 13).stdout.strip().splitlines()
    if not lines:
        fail(f"{name} printed no JSON line")
    return json.loads(lines[-1])


def _launched(res, what: str, sides=("fwd", "bwd")):
    """The K1 / K2 launches a script's JSON line reports; fails where one of
    them is 0 on `sides`."""
    got = res["launches"]
    if not all(got[k][s] > 0 for k in ("K1", "K2") for s in sides):
        fail(f"{what}: a step launched no kernel: {got}")
    return got


def phase_scripts(card):
    """Phase 13: the measurement scripts of the JAX package's `scripts/` as
    the port has them, each run on the card as a user runs it, its JSON line
    checked: the roofline at b=128 (every row and segment with FLOP and
    bytes, no floor share above 1, K1 and K2 launched and counted), the eval
    forwards at b=128, remat off / dots / full and volo_d4 / volo_d5 with 3
    timed steps, the outlook formulations at b=128 with the blockdiag and
    the fused rows (each fused row named after a kernel that launched), and
    the host loader at 512 images on the host's cores (at most 8): the
    ImageFolder mode, the record supply and records -> uint8 batches, with
    the native decoder loaded. Returns the launches of K1 and K2 by script,
    which are not the main path's (the report keeps them apart from its
    `launches`), and the K3 / K4 launches of the outlook rows."""
    launches = {}
    roof = _run_script("bench_roofline", [128], 300)
    for table in ("rows", "segments"):
        for name, r in roof[table].items():
            if not (r["flops"] > 0 and r["bytes"] > 0):
                fail(f"bench_roofline: {name} counted no FLOP or no bytes: {r}")
            if not 0 < r["floor_share"] <= 1:
                fail(f"bench_roofline: {name} at {r['floor_share']:.3f} of its floor")
    kernels = roof["rows"]["full step"]["kernels"]
    if not all(kernels.get(k, {}).get("launches", 0) > 0
               for k in ("K1 fwd", "K1 bwd", "K2 fwd", "K2 bwd")):
        fail(f"bench_roofline: the counted full step launched no K1 or K2: {kernels}")
    launches["bench_roofline"] = _launched(roof, "bench_roofline")
    full = roof["rows"]["full step"]
    say(f"phase 13 roofline b=128 on {card}: full step {full['ms']:.2f} ms, "
        f"{full['flops'] / 1e12:.3f} TFLOP ({'inside' if 4.2e12 <= full['flops'] <= 6.3e12 else 'OUTSIDE'}"
        f" the VOLO paper's 4.2-6.3), {full['bytes'] / 1e9:.2f} GB, MFU "
        f"{100 * roof['mfu']:.2f}%, {roof['img_per_s']:.1f} img/s")
    ev = _run_script("bench_eval", [128], 200)
    if len(ev["rows"]) != 5 or not all(v > 0 for v in ev["rows"].values()):
        fail(f"bench_eval: {ev['rows']}")
    launches["bench_eval"] = _launched(ev, "bench_eval", sides=("fwd",))
    rem = _run_script("bench_remat", ["--iters", 3], 300)
    if [r["mode"] for r in rem["rows"]] != ["off", "dots", "full"] or not all(
            r["ms"] > 0 and r["peak_gib"] > 0 for r in rem["rows"]):
        fail(f"bench_remat: {rem['rows']}")
    launches["bench_remat"] = _launched(rem, "bench_remat")
    fam = _run_script("bench_family", ["--iters", 3], 400)
    if [r["model"] for r in fam["rows"]] != ["volo_d4", "volo_d5"] or not all(
            r["ms"] > 0 and r["peak_gib"] > 0 for r in fam["rows"]):
        fail(f"bench_family: {fam['rows']}")
    launches["bench_family"] = _launched(fam, "bench_family")
    out = _run_script("bench_outlook", [128, "--blockdiag", "--fused"], 300)
    rows = {r["name"]: r for r in out["rows"]}
    need = {"K2 fused": ("fwd", "bwd"), "K3 hybrid": ("attend_hm", "bwd"),
            "K4 hybrid2": ("attend", "bwd")}
    for name, keys in need.items():
        if name not in rows or not all(rows[name]["launches"][k] > 0 for k in keys):
            fail(f"bench_outlook: the {name} row did not launch its kernels: {sorted(rows)}")
    attend = {k: sum(r["launches"][k] for r in out["rows"]) for k in ("attend_hm", "attend")}
    launches["bench_outlook"] = {"K1": {"fwd": 0, "bwd": 0}, "K2": {
        s: sum(r["launches"][s] for r in out["rows"]) for s in ("fwd", "bwd")}}
    workers = min(8, os.cpu_count() or 1)
    loader, root = {}, tempfile.mkdtemp(prefix="chip_smoke_loader_")
    for mode in ([], ["--tfrecord"], ["--tfrecord-e2e"]):    # the last two share the records
        res = _run_script("bench_loader", ["--images", 512, "--repeats", 1, "--workers",
                                           workers, "--root", root, *mode], 400)
        loader[mode[0] if mode else "folder"] = res["rows"]
    shutil.rmtree(root, ignore_errors=True)
    natives = [r for m in ("folder", "--tfrecord-e2e") for r in loader[m]
               if r["decoder"] == "native C++"]
    if len(natives) != 3 or not all(r["img_per_s"] > 0 for r in natives):
        fail(f"bench_loader: a native leg is missing: {loader}")
    say(f"phase 13 launches: {launches}, K3 / K4 {attend}")
    return launches, attend


def _run_launches(log_path: str):
    """The K1 / K2 launches a trainer's log counts on its last line
    (`kernel launches: {...}`)."""
    import ast
    found = re.findall(r"kernel launches: (\{.*\})", open(log_path).read())
    if not found:
        fail(f"{log_path} holds no 'kernel launches' line: the run did not end")
    return ast.literal_eval(found[-1])


def _arm_launches(what: str, logs):
    """The K1 / K2 launches of the trainer runs whose logs are `logs`,
    summed; fails where a run launched no K1 or no K2, forward or backward."""
    total = {k: {"fwd": 0, "bwd": 0} for k in ("K1", "K2")}
    for log in logs:
        got = _run_launches(log)
        if not all(got[k][s] > 0 for k in ("K1", "K2") for s in ("fwd", "bwd")):
            fail(f"{what}: the run of {log} launched no K1 or no K2: {got}")
        for k in total:
            for s in total[k]:
                total[k][s] += got[k][s]
    return total


def _run_logs(root: str, arm: str):
    return sorted(glob.glob(os.path.join(root, arm, "train", "*", "log.txt")))


def _accuracy_scripts(root: str):
    """`real_data_digits` (2 epochs, one seed), then `ab_procgen` (2 epochs,
    512 images at 64 px) and its `--summarize-only` on the same root; each
    arm a trainer in the script's process. Returns their launches."""
    launches = {}
    res = _run_module("real_data_digits", ["--epochs", 2, "--seeds", 42, "--root", root], 200,
                      14)
    for line in res.stdout.strip().splitlines():
        say(f"  > {line}")
    top1 = re.findall(r"\[seed 42\] fixed (\S+) .* autoprog (\S+) ", res.stdout)
    runs = os.path.join(root, "digits_runs")
    auto_logs = _run_logs(runs, "autoprog_s42")
    if not top1 or not all(math.isfinite(float(v)) for v in top1[0]) or not auto_logs or \
            "auto grow decision" not in open(auto_logs[-1]).read():
        fail("real_data_digits: no finite top-1 for both arms, or no AutoProg decision")
    launches["real_data_digits"] = _arm_launches(
        "real_data_digits", _run_logs(runs, "fixed_s42") + auto_logs)

    proc_root = os.path.join(root, "procgen_runs")
    cut = ["--epochs", 2, "--train-size", 512, "--num-classes", 10, "--img-size", 64, "-b", 32,
           "--stages", 2, "--seeds", 42, "--workers", 4, "--root", proc_root]
    res = _run_module("ab_procgen", cut, 200, 14)
    again = _run_module("ab_procgen", cut + ["--summarize-only"], 60, 14)
    for line in again.stdout.strip().splitlines():
        say(f"  > {line}")
    table = res.stdout[res.stdout.index("model="):] if "model=" in res.stdout else None
    if "[reuse] fixed s42" not in again.stdout or "[reuse] autoprog s42" not in again.stdout \
            or table is None or not again.stdout.endswith(table):
        fail("ab_procgen --summarize-only did not reuse the completed pair and print its "
             "table")
    launches["ab_procgen"] = _arm_launches(
        "ab_procgen", _run_logs(proc_root, "fixed_s42") + _run_logs(proc_root, "autoprog_s42"))
    return launches


def _search_sync_script():
    """`ab_search_sync` at 512 images and 10 probe batches: three `main_prog`
    processes; both timed legs must print a per-probe time. Returns their
    launches."""
    sync_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                             "ab_search_sync")
    before = set(glob.glob(os.path.join(sync_root, "*", "train", "*", "log.txt")))
    res = _run_module("ab_search_sync", ["--fake-data-size", 512, "--search-probe-steps", 10],
                      240, 14)
    for line in res.stdout.strip().splitlines():
        say(f"  > {line}")
    legs = re.findall(r"^(sync|desync)\s+per-probe\s+(\S+) ms \(n=(\d+)\)", res.stdout, re.M)
    if [leg for leg, _, _ in legs] != ["sync", "desync"] or not all(
            math.isfinite(float(ms)) and float(ms) > 0 and int(n) > 0 for _, ms, n in legs):
        fail(f"ab_search_sync: both timed legs must print a per-probe time: {legs}")
    new = sorted(set(glob.glob(os.path.join(sync_root, "*", "train", "*", "log.txt"))) - before)
    if len(new) != 3:
        fail(f"ab_search_sync: expected three new run logs, found {new}")
    return {"ab_search_sync": _arm_launches("ab_search_sync", new)}


def phase_ab_scripts(prog_run, fixed_run):
    """Phase 14: the A/B and accuracy scripts, each run as a user runs it, in
    a process of its own, at a cut: `analyze_rehearsal` over phase 5's and
    phase 4's logs, then the accuracy scripts (`_accuracy_scripts`, on a
    thread) beside `ab_search_sync`: their processes mostly wait on start-up
    and the host, so the two strands overlap (the search-sync times that
    phase prints are not a measurement). Checks the tables they print and
    reads each trainer run's K1 / K2 launches from its log. The two bench
    scripts (`ab_bf16_state`, `ab_sparse_tl`) are left out: phase 10
    already sets their switches on the card. Returns the launches by script, which
    are not the main path's."""
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.time()
    prog_log, fixed_log = (os.path.join(r, "log.txt") for r in (prog_run, fixed_run))
    res = _run_module("analyze_rehearsal", [prog_log, fixed_log], 60, 14)
    for line in res.stdout.strip().splitlines():
        say(f"  > {line}")
    decision = re.findall(r"auto grow decision: r=(\d+) l=(\d+)", open(prog_log).read())
    stages = re.findall(r"stage \d+: r=(\d+) h=\d+ l=(\d+)", res.stdout)
    totals = re.findall(r"total train-loop time: ([\d.]+)s", res.stdout)
    if f"decision: r={decision[0][0]} l={decision[0][1]}" not in res.stdout or \
            not stages or stages[-1] != ("224", "18") or len(totals) != 2:
        fail("analyze_rehearsal did not find phase 5's decision, its stages ending at "
             "r=224, l=18, and both runs' total train time")
    root = tempfile.mkdtemp(prefix="chip_smoke_ab_")
    with ThreadPoolExecutor(1) as pool:
        accuracy = pool.submit(_accuracy_scripts, root)
        launches = _search_sync_script()
        launches.update(accuracy.result())     # re-raises the thread's failure
    shutil.rmtree(root, ignore_errors=True)
    say(f"phase 14 launches: {launches}")
    say(f"phase 14: {time.time() - t_phase:.1f} s")
    return launches


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
    worst_ln, t_ln, _ = phase_layernorm(torch, card)
    phase_model_parity(torch)
    phase_outlook_model_parity(torch)
    from autoprog_tpu_torch.ops.attention import SHAPE_LAUNCHES
    from autoprog_tpu_torch.scripts.bench_k1 import SHAPES as bench_k1_shapes
    SHAPE_LAUNCHES.clear()
    fixed, fixed_k2, fixed_run, fixed_argv = phase_trainer(torch)
    prog_k1, prog_k2, prog_run, prog_argv = phase_prog_trainer(torch)
    deit_k1 = phase_deit(torch, card)
    measured, ran = phase_measure(torch)
    by_shape = dict(SHAPE_LAUNCHES)
    say(f"phase 7 K1 launches of phases 4 to 7 by (side, tokens, heads, head_dim): "
        f"{by_shape}")
    t = phase_kernel_times(torch, card)
    ts, loop1_counts = phase_k1_shape_times(torch, card)
    tv = phase_mhsa_variant_times(torch, card, t)
    to, variants = phase_outlook_times(torch, card)
    phase_step_times(torch, card)
    ck_k1, ck_k2 = phase_checkpoint(torch, card, fixed_run, fixed_argv, prog_run, prog_argv)
    op_k1, op_k2 = phase_options(torch, card)
    dp_k1, dp_k2 = phase_data_parallel(torch, card, fixed_run, fixed_argv, prog_argv)
    tp_k1, tp_k2 = phase_tensor_parallel(torch, card, prog_run, prog_argv)
    sc, sc_attend = phase_scripts(card)
    sc.update(phase_ab_scripts(prog_run, fixed_run))
    pal = "autoprog_tpu/ops/outlook_pallas.py"
    att = "autoprog_tpu/ops/attention_pallas.py"
    k1 = {side: fixed[side] + prog_k1[side] + deit_k1[side] + ck_k1[side] + op_k1[side] +
          dp_k1[side] + tp_k1[side] for side in ("fwd", "bwd")}
    k2 = {side: fixed_k2[side] + prog_k2[side] + ck_k2[side] + op_k2[side] + dp_k2[side] +
          tp_k2[side] for side in ("fwd", "bwd")}

    def scripts(kernel, side):
        """Phases 13's and 14's launches of a K1 / K2 side by script: the
        measurement and A/B scripts' own processes, kept out of the
        main path's `launches`."""
        return {"script_launches": {name: got[kernel][side] for name, got in sc.items()}}

    def vrow(key, src, replaces):
        return {"name": key, "route": "cuda", "source": src, "replaces": replaces,
                "launches": measured[key], "max_abs_err": worst_v[key], **tv[key],
                **({"kernel": ran[key]} if key in ran else {})}

    def shape_rows(B, n, H, d):
        for side, line in (("fwd", ":206"), ("bwd", ":228")):
            r = ts[side, n]
            common = {"route": "cuda", "plain_ms": r["plain"], "bound_ms": r["bound"][0],
                      "bound_by": r["bound"][1], "library_ms": r["lib"]}
            if by_shape.get((side, n, H, d), 0) <= 0:
                fail(f"no trainer or bench launched K1 {side} at n={n}, heads={H}, "
                     f"head_dim={d}")
            yield {"name": f"mhsa_qkv_{side}[B={B}, n={n}, C={H * d}, heads={H}]",
                   "source": MHSA_SRC, "replaces": att + line,
                   "launches": by_shape[side, n, H, d], "max_abs_err": worst[side],
                   "ms": r["bf16"], "ms_f32_scores": r["f32"], **common}
            yield {"name": f"loop_img1_{side}[B={B}, n={n}, C={H * d}, heads={H}]",
                   "source": VARIANTS_SRC, "replaces": "scripts/bench_attn_x.py:" +
                   ("69" if side == "fwd" else "86"),
                   "launches": loop1_counts["loop_img1_" + side],
                   "max_abs_err": worst_v["loop_img1_" + side], "ms": r["loop1"], **common}

    report = {"kernels": [
        {**_row("mhsa_qkv_fwd", MHSA_SRC, att + ":206", k1["fwd"], worst["fwd"], t, "fwd"),
         **scripts("K1", "fwd")},
        {**_row("mhsa_qkv_bwd", MHSA_SRC, att + ":228", k1["bwd"], worst["bwd"], t, "bwd"),
         **scripts("K1", "bwd")},
        {**_row("outlook_fused_fwd", OUTLOOK_SRC, pal + ":80", k2["fwd"], worst_o["fwd"],
                to, "fwd"),
         "ms_general": to["general_fwd"], "ms_f32": to["f32_fwd"],
         "ms_general_f32": to["f32_general_fwd"], **scripts("K2", "fwd")},
        {**_row("outlook_fused_bwd", OUTLOOK_SRC, pal + ":203", k2["bwd"], worst_o["bwd"],
                to, "bwd"),
         "ms_general": to["general_bwd"], "ms_f32": to["f32_bwd"],
         "ms_general_f32": to["f32_general_bwd"], **scripts("K2", "bwd")},
        _row("outlook_attend_hm", OUTLOOK_SRC, pal + ":237",
             variants["attend_hm"] + sc_attend["attend_hm"], worst_o["attend_hm"], to,
             "attend_hm"),
        _row("outlook_attend", OUTLOOK_SRC, pal + ":326",
             variants["attend"] + sc_attend["attend"], worst_o["attend"], to, "attend"),
        vrow("mhsa_fwd", MHSA_SRC, att + ":47"),
        vrow("mhsa_bwd", MHSA_SRC, att + ":67"),
        vrow("twophase", VARIANTS_SRC, "scripts/attn_variants.py:64"),
        vrow("twophase_bf16s", VARIANTS_SRC, "scripts/attn_variants.py:64"),
        vrow("pipelined", VARIANTS_SRC, "scripts/attn_variants.py:73"),
    ] + [vrow(f"{order}_img{G}_{side}", VARIANTS_SRC, "scripts/bench_attn_x.py:" + line)
         for order, G in GROUPS
         for side, line in (("fwd", "47" if order == "phase" else "69"), ("bwd", "86"))]
        + [row for shape in bench_k1_shapes for row in shape_rows(*shape)]
        + _ln_rows(worst_ln, t_ln)}
    say(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s on {card}")
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2], sys.argv[3])
    else:
        main()
