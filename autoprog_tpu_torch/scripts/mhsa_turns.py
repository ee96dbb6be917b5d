"""K1, K5 and every MHSA variant of this tree against another tree's (an
unpacked earlier commit), timed in turns on one card, and K1 / K5's SASS
compared.

    python -m autoprog_tpu_torch.scripts.mhsa_turns --parent DIR [--rounds N] [--out FILE]

Each tree's own wrappers make the calls (`ops.attention._launch_fwd` /
`_launch_bwd` / `_launch_fused_fwd` / `_launch_fused_bwd`,
`scripts.attn_variants._launch`, `scripts.bench_attn_x._launch_group_fwd` /
`_launch_group_bwd`), so nothing here copies either library's C interface.
A worker is this file run as a process with one tree first on `sys.path`
(that tree's `_build` builds its libraries under its own `build/kernels/`).
After one build worker for each tree, both at once, the timing workers run
in the order parent, this, this, parent, `--rounds` times; a row's time is
the mean over a tree's workers. A worker captures 50 calls of a row (30 of
a backward) in a CUDA graph and takes the least of three replays, so a call
of 20 us is timed on the card and not at the host's launch rate. Every
worker times, bf16, on the same inputs made on the card from fixed seeds:

  * K1's forward at bf16 and at f32 scores, and its backward at bf16
    scores fed the forward's statistics, at every shape of
    `scripts.bench_k1.SHAPES` (the trainers' shapes), and `loop_img1` (S1 at
    G = 1) forward and backward there;
  * K5's forward and backward, every S2 variant and every S1 variant forward
    and backward, at [128, 196, 384, 12 heads] (the benches' shape).

The SASS of each tree's `mhsa_qkv` library (K1 and K5) comes from
`cuobjdump -sass`; its kernels are compared as they stand and with register
and predicate numbers and branch targets renamed away, and for a kernel
that still differs, its instruction counts and how many instructions of
this tree's are not matched in the parent's.

Prints lines of text, then one JSON object as the last line (also written
to `--out`): {"card", "trees", "rows": [{name, parent_ms, ms, ratio}],
"sass": {"same", "same_but_registers", "other": [{name, instructions,
unmatched}]}}.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys

HERE = os.path.abspath(__file__)
THIS_TREE = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
# the benches' shape: [B, n, heads, head_dim]
BENCH_SHAPE = (128, 196, 12, 32)
GROUPS = [("phase", 1), ("phase", 2), ("phase", 4), ("loop", 1), ("loop", 2), ("loop", 4)]


def _ms(torch, fn, iters: int, warmup: int = 3, repeats: int = 3) -> float:
    """Milliseconds a call: `iters` calls captured in a CUDA graph, the least
    of `repeats` replays between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def _inputs(torch, B, n, H, d, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn(B, n, 3 * H * d, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(B, n, H * d, device="cuda", generator=gen).bfloat16()
    return qkv, dout


def worker_times(shapes) -> dict:
    """{row: ms} of the tree first on sys.path."""
    import torch
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.scripts import attn_variants as V
    from autoprog_tpu_torch.scripts import bench_attn_x as X
    rows = {}
    for B, n, H, d in shapes:
        qkv, dout = _inputs(torch, B, n, H, d, seed=n)
        scale, tag = d ** -0.5, f"[B={B}, n={n}, C={H * d}, heads={H}]"
        stats = A._launch_fwd(qkv, H, scale, False, want_stats=True)[1]
        rows[f"K1 fwd {tag}"] = _ms(torch, lambda: A._launch_fwd(qkv, H, scale, False), 50)
        rows[f"K1 fwd f32 scores {tag}"] = _ms(torch, lambda: A._launch_fwd(qkv, H, scale, True),
                                               50)
        rows[f"K1 bwd {tag}"] = _ms(
            torch, lambda: A._launch_bwd(qkv, dout, H, scale, False, stats), 30)
        rows[f"loop_img1 fwd {tag}"] = _ms(
            torch, lambda: X._launch_group_fwd("loop", 1, qkv, H, scale), 50)
        rows[f"loop_img1 bwd {tag}"] = _ms(
            torch, lambda: X._launch_group_bwd("loop", 1, qkv, dout, H, scale), 30)
    B, n, H, d = BENCH_SHAPE
    qkv, dout = _inputs(torch, B, n, H, d, seed=7)
    scale, tag = d ** -0.5, f"[B={B}, n={n}, C={H * d}, heads={H}]"
    q, k, v = (t.contiguous() for t in qkv.view(B, n, 3, H, d).unbind(2))
    g4 = dout.view(B, n, H, d)
    rows[f"K5 fwd {tag}"] = _ms(torch, lambda: A._launch_fused_fwd(q, k, v, scale), 50)
    rows[f"K5 bwd {tag}"] = _ms(torch, lambda: A._launch_fused_bwd(q, k, v, g4, scale), 30)
    for name in V._KERNELS:
        rows[f"{name} {tag}"] = _ms(torch, lambda: V._launch(name, qkv, H, scale), 50)
    for order, G in GROUPS:
        key = X.variant_name(order, G)
        if f"{key} fwd {tag}" in rows:
            continue
        rows[f"{key} fwd {tag}"] = _ms(
            torch, lambda: X._launch_group_fwd(order, G, qkv, H, scale), 50)
        rows[f"{key} bwd {tag}"] = _ms(
            torch, lambda: X._launch_group_bwd(order, G, qkv, dout, H, scale), 30)
    return rows


_BRANCH = re.compile(r"^(@!?U?P\w+\s+)?(BRA|BRX|BSSY|CALL|JMP|RET|WARPSYNC|BREAK|SYNCS)\b")


def normalise_sass(instr: str) -> str:
    """An instruction with its register and predicate numbers, and a
    branch's target, renamed away."""
    if _BRANCH.match(instr):
        instr = re.sub(r"0x[0-9a-f]+", "0x", instr)
    return re.sub(r"\b(U?R|U?P)\d+\b", r"\1", instr)


def parse_sass(text: str) -> dict:
    """{kernel: [instructions]} of `cuobjdump -sass` output, the name without
    the anonymous namespace's per-file hash."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            funcs[cur] = []
        elif cur:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
            if m:
                funcs[cur].append(m.group(1))
    return funcs


def short_kernel(name: str) -> str:
    """`kernel<template args>` of a mangled entry name (the name itself where
    it has no template arguments)."""
    kernel = re.search(r"\d+((?:mhsa|fwd|bwd)_[a-z_]+?)I(\S*?)EEv", name)
    if not kernel:
        return name
    return f"{kernel.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', kernel.group(2)))}>"


def compare_sass(mine: dict, theirs: dict) -> dict:
    """Kernels of `mine` (short names) with the same instructions as
    `theirs`, the same but for register numbers and branch targets, and the
    others, with their instruction counts (mine, theirs) and how many of
    mine are not matched in theirs once renamed."""
    out = {"same": [], "same_but_registers": [], "other": []}
    for name in sorted(mine):
        a, b = mine[name], theirs.get(name)
        short = short_kernel(name)
        if a == b:
            out["same"].append(short)
            continue
        na = [normalise_sass(i) for i in a]
        nb = [normalise_sass(i) for i in b or []]
        if na == nb and b is not None:
            out["same_but_registers"].append(short)
            continue
        matched = sum(m.size for m in difflib.SequenceMatcher(None, na, nb, autojunk=False)
                      .get_matching_blocks())
        out["other"].append({"name": short, "instructions": [len(a), len(nb)],
                             "unmatched": len(a) - matched})
    return out


def worker_sass() -> dict:
    from autoprog_tpu_torch import _build
    lib = next(p for p in _build.build() if p.name.startswith("mhsa_qkv"))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return parse_sass(out)


def _worker(tree: str, what: str, shapes=None, timeout: int = 900) -> dict:
    """Run this file as a worker with `tree` first on sys.path; its JSON."""
    env = {**os.environ, "PYTHONPATH": tree}
    proc = subprocess.run([sys.executable, HERE, "--worker", what, json.dumps(shapes)],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"worker {what} in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked tree of an earlier commit")
    ap.add_argument("--rounds", type=int, default=1,
                    help="how many times to run parent, this, this, parent")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    from autoprog_tpu_torch.scripts import bench_k1
    from autoprog_tpu_torch.scripts.timing import card_name
    import torch
    trees = {"parent": os.path.abspath(args.parent), "this": THIS_TREE}
    shapes = [list(s) for s in bench_k1.SHAPES]
    card = card_name(torch.device("cuda"))
    # both builds at once; each also reads its library's SASS
    builds = {who: subprocess.Popen(
        [sys.executable, HERE, "--worker", "sass", "null"], cwd=tree,
        env={**os.environ, "PYTHONPATH": tree}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for who, tree in trees.items()}
    sass = {}
    for who, proc in builds.items():
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {trees[who]} failed:\n{err[-4000:]}")
        sass[who] = json.loads(out.strip().splitlines()[-1])
    times = {"parent": [], "this": []}
    for _ in range(args.rounds):
        for who in ("parent", "this", "this", "parent"):
            times[who].append(_worker(trees[who], "times", shapes))
    rows = []
    for name in times["this"][0]:
        mean = {who: sum(t[name] for t in runs) / len(runs) for who, runs in times.items()}
        rows.append({"name": name, "parent_ms": mean["parent"], "ms": mean["this"],
                     "ratio": mean["this"] / mean["parent"]})
        print(f"{name:<48s} this {mean['this']:.4f} ms  parent {mean['parent']:.4f} ms  "
              f"this / parent {mean['this'] / mean['parent']:.4f}  (each tree's runs: "
              f"{[round(t[name], 5) for t in times['this']]} / "
              f"{[round(t[name], 5) for t in times['parent']]})", flush=True)
    compared = compare_sass(sass["this"], sass["parent"])
    print(f"K1 / K5 SASS: {len(compared['same'])} kernels the parent's instructions, "
          f"{len(compared['same_but_registers'])} the same but for register numbers and branch "
          f"targets {compared['same_but_registers']}, {len(compared['other'])} other:", flush=True)
    for k in compared["other"]:
        print(f"  {k['name']}: {k['instructions'][0]} instructions against the parent's "
              f"{k['instructions'][1]}, {k['unmatched']} not matched in the parent's", flush=True)
    result = {"card": card, "trees": trees, "rows": rows, "sass": compared}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        # run from a tree: drop this file's directory, keep PYTHONPATH's tree first
        sys.path[:] = [p for p in sys.path if os.path.abspath(p) != os.path.dirname(HERE)]
        what, shapes = sys.argv[2], json.loads(sys.argv[3])
        result = worker_sass() if what == "sass" else worker_times(shapes)
        print(json.dumps(result), flush=True)
    else:
        main()
