"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the port's train step for the
cell (kernels from `build/kernels/` inside the checkout, weights and a pool
of batches made on the card from the seed), runs the cell's first steps,
which warm up its shapes and give the readings of the correctness check,
and times a few more to size the window. The window then runs steps back
to back for about `--seconds` seconds. With `--trace 1` a short profiled
slice follows. Once the program's state is freed, the float32 reference
runs the first steps again and the comparison decides `correct`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with
`--trace 1` the per-layer ones), `device` (with `--trace 1` also `busy_s`
and `window_s`), with `--trace 1` `breakdown`, and last `checks`, each
compared number beside its limit (also the last lines of standard error).

A cell on more than one chip starts one process per chip (rank), each on
its own share of the host's cores, with torchrun's variables and NCCL; this
process only starts them, waits, and
prints rank 0's result. Without enough CUDA cards, or where a process has
loaded JAX or the JAX package, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()    # process start, on the wall clock that the ranks share

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "autoprog_tpu")
#: steps timed after the checked ones to size the window
SIZING_STEPS = 3
RANK_TIMEOUT_S = 330


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))


def launcher_env() -> None:
    """The process settings the recipe's launcher gives each rank: torchrun
    with more than one process a node sets OMP_NUM_THREADS=1 unless the
    caller set it, and a one-card cell is one rank of the recipe's 8-card
    launch. Set before PyTorch is loaded, as torchrun sets it before the
    rank starts."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def queue_env() -> None:
    """CUDA's launch queues at four times their default depth
    (`CUDA_SCALE_LAUNCH_QUEUES`, read when CUDA starts), unless the caller
    set them: the host then issues steps further ahead of the card, and a
    pause of the host (the machine stands still now and then) is spent while
    the card works through what was queued rather than idle. The work and
    the window are the same; only the host's lead grows."""
    os.environ.setdefault("CUDA_SCALE_LAUNCH_QUEUES", "4x")


def _all_gather(obj, world: int):
    if world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _mean_over_ranks(world: int):
    if world == 1:
        return None
    import torch.distributed as dist

    def mean(t):
        t = t.clone()
        dist.all_reduce(t)
        return t / world
    return mean


def setup(cell, seed: int, device, rank: int, world: int):
    """The program built for the cell, its pool of this rank's rows, and the
    readings of its first steps (device tensors)."""
    import torch
    from benchmark import correct, inputs, program
    from benchmark.reference.train import param_shapes
    cfg, rec = cell.model, cell.traffic["recipe"]
    shapes = param_shapes(cfg)
    pool = [inputs.rows(inputs.make_batch(cell.traffic, cfg, seed, k, cell.global_batch,
                                          device), rank, world)
            for k in range(cell.traffic["pool_batches"])]
    prog = program.build(cell, inputs.make_weights(shapes, seed, device), device, seed, rank)
    readings = correct.program_readings(
        prog, pool[:correct.CHECK_STEPS],
        lambda: inputs.make_weights(shapes, seed, device), rec["betas"][0],
        _mean_over_ranks(world))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return prog, pool, readings


def reference_readings(cell, seed: int, device, precision: str = "float32") -> dict:
    """The reference's readings from the same weights and global batches.
    Every cell's reference recomputes its blocks in the backward: the same
    float32 operations run again, so no value changes, and a cell sized
    to fill the card leaves room for the reference's float32 activations
    (the stem's stay saved)."""
    from benchmark import correct, inputs
    from benchmark.reference.train import param_shapes, run_steps
    cfg = cell.model
    batches = [inputs.make_batch(cell.traffic, cfg, seed, k, cell.global_batch, device)
               for k in range(correct.CHECK_STEPS)]
    weights = inputs.make_weights(param_shapes(cfg), seed, device)
    return run_steps(weights, batches, cfg, cell.traffic["recipe"], precision,
                     checkpoint_blocks=True)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def run_rank(cell, seed: int, seconds: float, trace_on: bool, rank: int = 0,
             world: int = 1, t0: float = T0, device=None) -> dict:
    """One rank's part of a run; rank 0 returns the result, the others a
    record of what they loaded."""
    import torch
    from benchmark import correct, program, trace, window
    if device is None:
        device = torch.device("cuda", rank)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    if world > 1:
        program.init_distributed()
    prog, pool, readings = setup(cell, seed, device, rank, world)
    n_pool, start = len(pool), correct.CHECK_STEPS

    def step(i):
        return prog.step(pool[i % n_pool])

    est = window.estimate_ms(step, start, SIZING_STEPS, device)
    est = max(_all_gather(est, world))
    n_steps = max(1, math.ceil(seconds * 1e3 / est))
    start += SIZING_STEPS
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = window.run(step, start, n_steps, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    start += n_steps
    traced = None
    if trace_on:
        traced = trace.profile(step, start, trace.TRACE_STEPS, device)
    mine = {"rank": rank, "intervals_ms": win["intervals_ms"], "wall_s": win["wall_s"],
            "nonfinite": win["nonfinite"], "window_peak": window_peak,
            "peak": max(setup_peak, window_peak,
                        torch.cuda.max_memory_allocated(device) if cuda else 0),
            "busy_window_s": None if traced is None else (traced["busy_s"],
                                                          traced["window_s"]),
            "forbidden": forbidden_modules()}
    launches = program.launches()
    host = correct.to_host(readings)
    ranks = _all_gather(mine, world)
    del prog, pool, readings
    free(device)
    if world > 1:
        program.destroy_distributed()
    if rank != 0:
        return mine
    iv = sorted(win["intervals_ms"])
    med = iv[len(iv) // 2]
    print(f"# {cell.name}: {n_steps} steps in {win['wall_s']:.3f} s (sized at {est:.3f} ms "
          f"a step); intervals median {med:.3f}, max {iv[-1]:.3f} ms, "
          f"{sum(v > 1.05 * med for v in iv)} over 1.05x the median, first five "
          f"{[round(v, 2) for v in win['intervals_ms'][:5]]}; kernel launches {launches}",
          file=sys.stderr)
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    print(f"# reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    nums = correct.numbers(host, ref)
    failed = sum(r["nonfinite"] for r in ranks)
    verdict = correct.judge(nums, cell.traffic["limits"], failed)
    for name, n in nums.items():
        if n["leaf"]:
            print(f"# {name}: worst leaf {n['leaf']}", file=sys.stderr)
    return compose(cell, win, ranks, traced, verdict, n_steps, t0, device)


def compose(cell, win, ranks, traced, verdict, n_steps, t0, device) -> dict:
    import torch
    from benchmark import window
    wall = max(r["wall_s"] for r in ranks)
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                  else "cpu",
                  "count": cell.chips, "memory_peak_bytes": max(r["peak"] for r in ranks)}
    out = {"correct": verdict["correct"], "attempted": n_steps,
           "failed": sum(r["nonfinite"] for r in ranks)}
    if traced is None:
        values = {"train_img_per_s": window.images_per_s({"steps": n_steps, "wall_s": wall},
                                                          cell.global_batch),
                  "setup_s": win["start_time"] - t0}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        ctx = {"config": cell.model, "batch": cell.batch, "chips": cell.chips,
               "window": {"steps": n_steps, "wall_s": wall, "images": n_steps * cell.global_batch,
                          "interval_sets": [r["intervals_ms"] for r in ranks]},
               "trace": traced,
               "ranks": [{"wall_s": r["wall_s"],
                          "busy_per_step_s": r["busy_window_s"][0] / traced["steps"]}
                         for r in ranks],
               "window_peak_bytes": max(r["window_peak"] for r in ranks)}
        out["metrics"] = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].compute(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        n = len(ranks)
        device_rec["busy_s"] = sum(r["busy_window_s"][0] for r in ranks) / n
        device_rec["window_s"] = sum(r["busy_window_s"][1] for r in ranks) / n
    out["device"] = device_rec
    if traced is not None:
        out["breakdown"] = traced["breakdown"]
    out["checks"] = verdict["checks"]
    out["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pin_rank(rank: int, world: int) -> None:
    """Keep this rank's process on its own contiguous share of the cores it
    was started with, so that no two ranks' launch threads contend for a
    core (all of them where there are fewer cores than ranks). Called before
    PyTorch is loaded, so that its thread pools size to the share."""
    cores = sorted(os.sched_getaffinity(0))
    n = len(cores) // world
    if n:
        os.sched_setaffinity(0, cores[rank * n:(rank + 1) * n])


def spawn_ranks(argv_tail, world: int, module: str = "benchmark.run",
                timeout_s: float = RANK_TIMEOUT_S) -> int:
    """Start one process per rank (`python -m <module> ... --rank r`), wait
    for all, and return the worst exit code; a rank that fails or overruns
    ends the others. Each rank moves itself onto its own cores
    (`pin_rank`) before it loads PyTorch."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        cmd = [sys.executable, "-m", module, *argv_tail, "--rank", str(r),
               "--world", str(world)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=sys.stderr))
    deadline = time.time() + timeout_s
    rcs = [None] * world
    try:
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            rcs[i] = p.wait()
    return max(abs(rc) for rc in rcs)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the rank processes of a cell on more than one chip
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 1


def emit(result: dict) -> int:
    """Print the result line, or fail where a process loaded what it may not."""
    bad = sorted(set(result.pop("forbidden")) | set(forbidden_modules()))
    if bad:
        return fail(f"modules loaded that the benchmark forbids: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        pin_rank(args.rank, args.world)
    launcher_env()
    queue_env()
    cache_env()
    from benchmark import spec
    cell = spec.load(args.workload)
    import torch
    if args.rank is not None:                        # one rank of a multi-chip cell
        res = run_rank(cell, args.seed, args.seconds, bool(args.trace), args.rank,
                       args.world, args.t0)
        Path(args.out, f"rank{args.rank}.json").write_text(json.dumps(res))
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if cell.chips == 1:
        return emit(run_rank(cell, args.seed, args.seconds, bool(args.trace)))
    from benchmark import program
    program.build_kernels()
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as out:
        tail = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", repr(args.seconds), "--trace", str(args.trace),
                "--out", out, "--t0", repr(T0)]
        rc = spawn_ranks(tail, cell.chips)
        if rc != 0:
            return fail(f"a rank exited with {rc}")
        ranks = [json.loads(Path(out, f"rank{r}.json").read_text())
                 for r in range(cell.chips)]
    result = ranks[0]
    result["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
