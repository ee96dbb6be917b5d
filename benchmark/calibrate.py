"""Readings from which a cell's correctness limits are set (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--control 3] [--fault half_batch] [--out <file.json>]

For each seed: the program's first steps at the cell's own size, exactly as
a run's set-up makes them, against the float32 reference: the sound
readings (the lower readings of the limits). The control, on the first
`--control` seeds: the reference computed in float8 put in the program's
place (the upper readings). `--fault` plants a fault of `faults.py` under
the program for every seed instead. No window is measured: the readings
come from set-up. A cell on more than one chip runs one process per chip
as `run.py` does; rank 0 runs the references. One JSON line per seed and
reading, then a summary line (largest sound reading, smallest control
reading, per number).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from benchmark import run


def _line(kind: str, seed: int, nums: dict) -> dict:
    return {"kind": kind, "seed": seed, **{k: v["value"] for k, v in nums.items()},
            "leaves": {k: v["leaf"] for k, v in nums.items() if v["leaf"]}}


def calibrate_rank(cell, seeds, control: int, fault, rank: int = 0, world: int = 1,
                   device=None):
    import torch
    from benchmark import correct, faults, program
    if device is None:
        device = torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        program.init_distributed()
    lines = []
    for i, seed in enumerate(seeds):
        ctx = faults.planted(fault) if fault else contextlib.nullcontext()
        with ctx:
            prog, pool, readings = run.setup(cell, seed, device, rank, world)
        host = correct.to_host(readings)
        del prog, pool, readings
        run.free(device)
        if rank == 0:
            t_ref = time.perf_counter()
            ref = run.reference_readings(cell, seed, device)
            print(f"# reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
            lines.append(_line(f"fault:{fault}" if fault else "program", seed,
                               correct.numbers(host, ref)))
            if i < control:
                ctl = run.reference_readings(cell, seed, device, "fp8")
                lines.append(_line("control", seed, correct.numbers(ctl, ref)))
            for ln in lines[-2:]:
                print(json.dumps(ln), file=sys.stderr, flush=True)
        del host
        run.free(device)
        if world > 1:
            torch.distributed.barrier()
    if world > 1:
        program.destroy_distributed()
    return lines


def summary(lines) -> dict:
    out = {}
    for kind in sorted({ln["kind"] for ln in lines}):
        rows = [ln for ln in lines if ln["kind"] == kind]
        agg = min if kind == "control" else max
        out[kind] = {n: agg(r[n] for r in rows) for n in ("loss_gap", "grad_gap",
                                                          "update_gap", "ema_gap")}
        out[kind]["seeds"] = len(rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        run.pin_rank(args.rank, args.world)
    run.cache_env()
    from benchmark import spec
    cell = spec.load(args.workload)
    if args.rank is not None:
        lines = calibrate_rank(cell, args.seeds, args.control, args.fault, args.rank,
                               args.world)
        if args.rank == 0:
            Path(args.out).write_text(json.dumps(lines))
        return 0
    if cell.chips == 1:
        lines = calibrate_rank(cell, args.seeds, args.control, args.fault)
    else:
        from benchmark import program
        program.build_kernels()
        out = Path(args.out or run.ROOT / "build" / "calibrate_ranks.json").resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        tail = ["--workload", args.workload, "--seeds", *map(str, args.seeds),
                "--control", str(args.control), "--out", str(out)]
        if args.fault:
            tail += ["--fault", args.fault]
        rc = run.spawn_ranks(tail, cell.chips, module="benchmark.calibrate", timeout_s=3000)
        if rc:
            return run.fail(f"a rank exited with {rc}")
        lines = json.loads(out.read_text())
    result = {"workload": args.workload, "fault": args.fault, "lines": lines,
              "summary": summary(lines)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
