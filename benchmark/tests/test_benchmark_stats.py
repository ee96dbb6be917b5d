"""The window's arithmetic and the trace readers on synthetic inputs."""

from __future__ import annotations

import json

import pytest

from benchmark import cost, trace, window
from benchmark.metrics import _kernels
from conftest import REPO
from benchmark import spec


def test_p95_and_rate_see_a_stall():
    intervals = [80.0] * 190 + [400.0] * 10          # ten stalls of 400 ms
    assert window.percentile(intervals, 50) == 80.0
    assert window.percentile(intervals, 95) == pytest.approx(80.0 + (400 - 80) * 0.05)
    assert window.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    wall = sum(intervals) / 1e3
    assert window.images_per_s({"steps": 200, "wall_s": wall}, 128) == pytest.approx(
        200 * 128 / wall)
    assert window.step_p95([intervals]) == window.percentile(intervals, 95)


def test_across_chips_a_step_is_its_slowest_rank():
    a = [10.0, 10.0, 50.0, 10.0]
    b = [30.0, 10.0, 10.0, 10.0]
    assert window.step_p95([a, b]) == window.percentile([30.0, 10.0, 50.0, 10.0], 95)


KERNELS = [("void mhsa_fwd_res<__nv_bfloat16, 32>(...)", 0.0, 100.0),
           ("ampere_bf16_gemm", 50.0, 100.0),            # overlaps the first
           ("void mhsa_bwd_res<__nv_bfloat16>(...)", 200.0, 300.0),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 600.0, 50.0),
           ("void outlook_fwd_rows<__nv_bfloat16>(...)", 700.0, 100.0)]
HOST = [("aten::mm", 140.0, 70.0), ("bench.step", 0.0, 1000.0), ("aten::item", 550.0, 60.0)]


def test_busy_union_and_gaps():
    assert trace.busy_us(KERNELS) == 150 + 300 + 50 + 100
    assert trace.gaps(KERNELS) == [(150.0, 200.0), (500.0, 600.0), (650.0, 700.0)]


def test_breakdown_names_gaps_by_the_innermost_host_op():
    b = trace.breakdown(KERNELS, HOST)
    assert b["device_ops"][0] == ["void mhsa_bwd_res<__nv_bfloat16>(...)", 300e-6]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mm (x1)"] == pytest.approx(50e-6)
    assert gaps["aten::item (x1)"] == pytest.approx(100e-6)
    assert gaps["bench.step (x1)"] == pytest.approx(50e-6)


def _ctx(kernels, steps=1):
    cfg = json.loads((REPO / "benchmark/configs/volo_d1.json").read_text())
    return {"config": cfg, "batch": 128, "chips": 1,
            "trace": {"kernels": kernels, "steps": steps},
            "ranks": [{"wall_s": 2.0, "busy_per_step_s": 0.12},
                      {"wall_s": 1.6, "busy_per_step_s": 0.144}],
            "window_peak_bytes": 3 * 2 ** 30,
            "window": {"steps": 10, "wall_s": 2.0, "images": 1280,
                       "interval_sets": [[80.0] * 19 + [400.0], [90.0] * 20]}}


def test_roofline_shares_and_null_where_nothing_matches():
    readers = spec.load("volo_d1-b256").readers
    ctx = _ctx(KERNELS, steps=2)
    least = sum(cost.least_s(*cost.k1_work(side, *shape), cost.BF16_FLOPS)
                for shape in cost.mhsa_shapes(ctx["config"], 128) for side in ("fwd", "bwd"))
    assert readers["mhsa_roofline_pct"].compute(ctx) == pytest.approx(
        100 * least * 2 / 400e-6)
    k2 = sum(cost.least_s(*cost.k2_work(side, *shape), cost.F32_FLOPS)
             for shape in cost.outlook_shapes(ctx["config"], 128) for side in ("fwd", "bwd"))
    assert readers["outlook_roofline_pct"].compute(ctx) == pytest.approx(100 * k2 * 2 / 100e-6)
    none = _ctx([("ampere_bf16_gemm", 0.0, 10.0)])
    assert readers["mhsa_roofline_pct"].compute(none) is None
    assert readers["outlook_roofline_pct"].compute(none) is None
    assert _kernels.share_pct(1.0, [], "x", 1) is None


def test_the_other_readers():
    readers = spec.load("volo_d1-b256").readers
    ctx = _ctx(KERNELS, steps=2)
    # per chip, 1 - busy a step x the window's steps / the window's wall:
    # 1 - 1.2 / 2.0 and 1 - 1.44 / 1.6, averaged
    assert readers["device_idle_pct"].compute(ctx) == pytest.approx(25.0)
    assert readers["peak_mem_gib"].compute(ctx) == 3.0
    assert readers["step_ms_p95"].compute(ctx) == pytest.approx(90.0 + (400 - 90) * 0.05)
    flop = cost.train_flops_per_image(ctx["config"]) * 1280
    assert readers["step_mfu_pct"].compute(ctx) == pytest.approx(
        100 * flop / 2.0 / cost.BF16_FLOPS)


class _Range:
    def __init__(self, start, dur):
        self.start, self._dur = start, dur

    def elapsed_us(self):
        return self._dur


class _Event:
    def __init__(self, name, device, start, dur):
        import torch
        self.name, self.time_range = name, _Range(start, dur)
        self.device_type = getattr(torch.autograd.DeviceType, device)


class _Prof:
    def events(self):
        return [_Event("bench.step", "CPU", 0.0, 100.0), _Event("bench.step", "CUDA", 0.0, 100.0),
                _Event("aten::mm", "CPU", 1.0, 5.0), _Event("sm90_gemm", "CUDA", 10.0, 20.0)]


def test_host_spans_mirrored_on_the_device_are_no_device_activity():
    dev, host = trace._events(_Prof())
    assert dev == [("sm90_gemm", 10.0, 20.0)]
    assert {h[0] for h in host} == {"bench.step", "aten::mm"}
