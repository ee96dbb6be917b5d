"""The port's measurement scripts (`autoprog_tpu_torch/scripts/bench_roofline,
bench_loader, bench_eval, bench_remat, bench_family, bench_outlook`) on the
CPU at a tiny size (AUTOPROG_TORCH_DEVICE=cpu; the bench's model shrunk to
volo_h2_l4 at 32 px, batch 2, one step a row; the loader at 32 images, no
worker process): each prints its rows and ends stdout with one JSON line
that equals what `main` returns. Times taken here say nothing of the card;
`chip_smoke.py` phase 13 runs the same scripts there.

The roofline's counts are held exactly: K1's and K2's work formulas
(`scripts/cost.py`, what `chip_smoke.py`'s bounds and the roofline add for
the kernels' launches) against `FlopCounterMode` on their plain twins at the
same shape; the counter's FLOP against `FlopCounterMode` over a model's
forward and backward; an element-wise op's bytes as its input plus its
output, a view's as none.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from autoprog_tpu_torch import bench
from autoprog_tpu_torch.scripts import (bench_eval, bench_family, bench_loader,
                                        bench_outlook, bench_remat, bench_roofline, cost)

KNOBS = ("AUTOPROG_BENCH_EMA_BF16", "AUTOPROG_BENCH_MU_BF16", "AUTOPROG_SPARSE_TL")


@pytest.fixture
def tiny(monkeypatch):
    """The CPU, the bench's recipe at volo_h2_l4 and 32 px, no knobs."""
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    for env in KNOBS:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(bench, "MODEL", "volo_h2_l4")
    monkeypatch.setattr(bench, "IMG_SIZE", 32)


def _json_line(capsys, result):
    out = capsys.readouterr().out.strip().splitlines()
    assert out and json.loads(out[-1]) == json.loads(json.dumps(result))
    return result


def test_bench_roofline_rows_segments_and_floors(tiny, capsys):
    res = _json_line(capsys, bench_roofline.main(["2"]))
    rows, segs = res["rows"], res["segments"]
    assert list(rows) == ["full step", "no outlookers", "no transformers",
                          "stem+post+heads+opt only"]
    assert list(segs) == ["outlooker segment", "transformer segment",
                          "rest (stem, post, heads, loss, optimizer, EMA)", "TOTAL full step"]
    assert res["card"] == "cpu" and res["batch"] == 2
    for r in rows.values():
        assert r["ms"] > 0 and r["flops"] > 0 and r["bytes"] > 0
        assert r["kernels"] == {}          # the twins ran: their ops are in the counts
        assert r["flops"] == sum(r["flops_by_dtype"].values())
        assert r["flop_floor_ms"] == pytest.approx(
            sum(f / cost.PEAKS[dt] for dt, f in r["flops_by_dtype"].items()) * 1e3)
        assert r["byte_floor_ms"] == pytest.approx(r["bytes"] / cost.HBM_BPS * 1e3)
        assert r["floor_share"] == pytest.approx(
            max(r["flop_floor_ms"], r["byte_floor_ms"]) / r["ms"])
    # the split by the model's top-level children adds up to the counts,
    # and a masked block stage shows up only where it ran
    for name, r in rows.items():
        parts = r["by_part"]
        assert sum(w["bytes"] for w in parts.values()) == r["bytes"]
        assert sum(w["flops"] for w in parts.values()) == r["flops"]
        assert parts["patch_embed"]["bytes"] > 0 and parts["outside the model"]["bytes"] > 0
        assert ("s1b*" in parts) == (name in ("full step", "no outlookers"))
        assert list(r["top_ops"].values()) == sorted(r["top_ops"].values(), reverse=True)
    # each layer the mask drops takes FLOP and bytes out of the step
    full = rows["full step"]
    for name in ("no outlookers", "no transformers"):
        assert rows[name]["flops"] < full["flops"] and rows[name]["bytes"] < full["bytes"]
    for key in ("ms", "flops", "bytes"):
        assert segs["outlooker segment"][key] == full[key] - rows["no outlookers"][key]
        assert segs["transformer segment"][key] == full[key] - rows["no transformers"][key]
        assert segs["TOTAL full step"][key] == full[key]
    assert res["img_per_s"] == pytest.approx(2 / (full["ms"] / 1e3))
    assert res["mfu"] == pytest.approx(full["flops"] / (full["ms"] / 1e3) / cost.BF16_FLOPS)
    assert res["launches"] == {"K1": {"fwd": 0, "bwd": 0}, "K2": {"fwd": 0, "bwd": 0},
                               "LN": {"fwd": 0, "bwd": 0}}


@pytest.mark.parametrize("side", ["fwd", "bwd"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernel_work_equals_flop_counter_on_the_twins(kernel, side):
    """The FLOP a kernel's formula gives is what FlopCounterMode counts on
    its plain twin at the same shape, forward and backward."""
    from autoprog_tpu_torch.ops import attention as A
    from autoprog_tpu_torch.ops import outlook_fused as O
    g = torch.Generator().manual_seed(0)
    if kernel == "K1":
        B, n, H, d = 2, 20, 3, 8
        qkv, dout = torch.randn(B, n, 3 * H * d, generator=g), torch.randn(B, n, H * d)
        fn = (lambda: A.mhsa_fused_qkv_reference(qkv, H, 0.3)) if side == "fwd" else \
            (lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, H, 0.3))
        flops, nbytes = cost.k1_work(side, B, n, H, d, item=4)
        want_bytes = (4 if side == "fwd" else 7) * B * n * H * d * 4
    else:
        B, Hm, Wm, C, heads = 2, 8, 6, 12, 3
        v, gout = torch.randn(B, Hm, Wm, C, generator=g), torch.randn(B, Hm, Wm, C)
        logits = torch.randn(B, Hm // 2, Wm // 2, heads * 81, generator=g)
        fn = (lambda: O.outlook_attention_fused_reference(v, logits, heads, 0.5)) \
            if side == "fwd" else \
            (lambda: O.outlook_attention_backward_reference(v, logits, gout, heads, 0.5))
        flops, nbytes = cost.k2_work(side, B, Hm, Wm, C, heads, item=4)
        maps, logit_b = v.numel() * 4, logits.numel() * 4
        want_bytes = 2 * maps + logit_b if side == "fwd" else 3 * maps + 2 * logit_b
    with FlopCounterMode(display=False) as fc:
        fn()
    assert flops == fc.get_total_flops() > 0
    assert nbytes == want_bytes


def test_work_counter_flops_equal_flop_counter_mode():
    """Over a model's forward and backward (deit_h2_l2, f32), the counter's
    FLOP split by dtype sum to FlopCounterMode's total."""
    from autoprog_tpu_torch import create_model
    torch.manual_seed(0)
    net = create_model("deit_h2_l2").make(num_classes=8, img_size=32, dtype=torch.float32)
    x = torch.randn(2, 32, 32, 3)

    def step():
        net(x, train=False).float().pow(2).sum().backward()
    with FlopCounterMode(display=False) as fc:
        step()
    with bench_roofline.WorkCounter() as wc:
        step()
    assert dict(wc.flops) == {"float32": fc.get_total_flops()} and wc.flops["float32"] > 0


def test_work_counter_bytes():
    """An element-wise op moves its input and its output; a view nothing;
    an in-place `_foreach_` op reads and writes every tensor of its list."""
    a = torch.randn(64, 32)
    with bench_roofline.WorkCounter() as wc:
        torch.exp(a)
    assert wc.bytes == 2 * a.numel() * 4
    with bench_roofline.WorkCounter() as wc:
        a.view(32, 64).t()
    assert wc.bytes == 0
    xs = [torch.randn(10), torch.randn(20)]
    with bench_roofline.WorkCounter() as wc:
        torch._foreach_mul_(xs, 2.0)
    assert wc.bytes == 2 * 30 * 4


def test_kernel_work_adds_each_launch_at_the_step_shape():
    """K1's launches by (side, tokens, heads, head_dim) at the step's batch,
    K2's at its one map, in f32 arithmetic; two maps in one step raise."""
    work = bench_roofline.kernel_work(
        128, {("fwd", 196, 12, 32): 14, ("bwd", 196, 12, 32): 14}, {"fwd": 4, "bwd": 4},
        {(128, 28, 28, 192, 6)}, 2, "bfloat16")
    assert work["K1 fwd"] == {"launches": 14, "dtype": "bfloat16",
                              "flops": 14 * cost.k1_work("fwd", 128, 196, 12, 32)[0],
                              "bytes": 14 * cost.k1_work("fwd", 128, 196, 12, 32)[1]}
    assert work["K2 bwd"]["flops"] == 4 * cost.k2_work("bwd", 128, 28, 28, 192, 6)[0]
    assert work["K2 bwd"]["dtype"] == "float32"
    with pytest.raises(RuntimeError, match="2 maps"):
        bench_roofline.kernel_work(2, {}, {"fwd": 1, "bwd": 0},
                                   {(2, 8, 8, 16, 2), (2, 4, 4, 16, 2)}, 2, "bfloat16")


def test_bench_outlook_rows(tiny, capsys):
    res = _json_line(capsys, bench_outlook.main(["2", "--blockdiag", "--fused"]))
    names = [r["name"] for r in res["rows"]]
    assert names == ["broadcast (default)", "broadcast custom-vjp", "blockdiag g=4",
                     "blockdiag g=7", "blockdiag g=14", "blockdiag g=28",
                     "K2 fused [plain twin]", "K3 hybrid [plain twin]",
                     "K4 hybrid2 [plain twin]"]
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in res["rows"])
    assert all(not any(r["launches"].values()) for r in res["rows"])
    assert res["shape"] == [2, 28, 28, 192] and res["heads"] == 6 and res["card"] == "cpu"


def test_bench_eval_rows(tiny, capsys):
    res = _json_line(capsys, bench_eval.main(["2"]))
    assert list(res["rows"]) == ["eval fwd full", "train fwd full", "eval fwd no outlookers",
                                 "eval fwd no transformers", "eval fwd stem+post only"]
    assert all(v > 0 for v in res["rows"].values()) and res["batch"] == 2


def test_bench_remat_rows(tiny, capsys):
    res = _json_line(capsys, bench_remat.main(
        ["--model", "volo_h2_l4", "--batch", "2", "--img", "32", "--iters", "1"]))
    assert [r["mode"] for r in res["rows"]] == ["off", "dots", "full"]
    assert res["rows"][0]["vs_off"] == 1.0
    for r in res["rows"]:
        assert r["ms"] > 0 and r["img_per_s"] == pytest.approx(2e3 / r["ms"])
        assert r["peak_gib"] is None       # no device memory on the CPU


def test_bench_family_runs_nothing_at_import_and_its_configs(tiny, capsys, monkeypatch):
    importlib.reload(bench_family)
    assert capsys.readouterr().out == ""
    assert bench_family.CONFIGS == [("volo_d4", 32, "full"), ("volo_d5", 8, "full")]
    monkeypatch.setattr(bench_family, "CONFIGS", [("volo_h2_l4", 2, "full")])
    res = _json_line(capsys, bench_family.main([]))
    (row,) = res["rows"]
    assert row["model"] == "volo_h2_l4" and row["remat"] == "full" and row["ms"] > 0
    from autoprog_tpu_torch import create_model
    want = sum(p.numel() for p in create_model("volo_h2_l4").make(img_size=32).parameters())
    assert row["params"] == want


def test_bench_family_lets_a_failure_end_the_run(tiny, monkeypatch):
    monkeypatch.setattr(bench_family, "CONFIGS", [("volo_no_such_model", 2, "full")])
    with pytest.raises(Exception):
        bench_family.main([])


def test_bench_loader_modes(tiny, capsys, tmp_path):
    """The ImageFolder mode (native and PIL, with and without RandAugment),
    the record supply and records -> uint8 batches, on records this script
    wrote with the masked CRC that the reader checks."""
    from autoprog_tpu_torch.data.tfrecord import read_records
    base = ["--images", "32", "--workers", "0", "--repeats", "1", "--batch-size", "8",
            "--root", str(tmp_path)]
    res = _json_line(capsys, bench_loader.main(base))
    assert [(r["decoder"], r["aug"]) for r in res["rows"]] == [
        ("PIL", bench_loader.RANDAUG), ("native C++", bench_loader.RANDAUG),
        ("PIL", "no-randaug"), ("native C++", "no-randaug")]
    assert all(r["img_per_s"] > 0 for r in res["rows"]) and res["card"] == "cpu"
    res = _json_line(capsys, bench_loader.main(base + ["--tfrecord"]))
    assert res["rows"][0]["records_per_s"] > 0
    files = sorted((tmp_path / "tfrecord").glob("train-*"))
    assert len(files) == 4
    assert sum(1 for f in files for _ in read_records(str(f), verify_crc=True)) == 32
    res = _json_line(capsys, bench_loader.main(base + ["--tfrecord-e2e"]))
    assert [r["decoder"] for r in res["rows"]] == ["native C++", "PIL"]
    assert all(r["img_per_s"] > 0 for r in res["rows"])
    assert "AUTOPROG_NO_NATIVE" not in os.environ


def test_bench_loader_native_leg_requires_the_library(tiny, monkeypatch, tmp_path):
    from autoprog_tpu_torch.data import native
    monkeypatch.setattr(native, "load_library", lambda: None)
    bench_loader.make_jpeg_folder(str(tmp_path), 4)
    closing = []
    with pytest.raises(RuntimeError, match="did not load"):
        bench_loader.drive(str(tmp_path), closing, workers=0, use_native=True, batch_size=2)
    assert not closing
    assert bench_loader.drive(str(tmp_path), closing, workers=0, use_native=False,
                              batch_size=2) > 0
    assert np.isfinite(bench_loader.drive(str(tmp_path), closing, workers=0,
                                          use_native=False, batch_size=2, auto_augment=""))
    for t in closing:
        t.join()
    assert len(closing) == 2 and not any(t.is_alive() for t in closing)


def test_native_image_library_builds_against_pillows_libjpeg(tmp_path, monkeypatch):
    """`_build.build_native_image` (a host without libjpeg's development
    files): native/fastimage.cpp compiled against the headers of csrc/jpeg/
    and Pillow's libjpeg decodes, crops and resizes a JPEG to the same bytes
    as the library the data pipeline loads; an existing library is kept."""
    import ctypes
    import io
    import shutil
    from PIL import Image
    from autoprog_tpu_torch import _build
    from autoprog_tpu_torch.data import native
    shutil.copy(_build.NATIVE_DIR / "fastimage.cpp", tmp_path)
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    out = _build.build_native_image()
    assert out == tmp_path / "libfastimage.so" and _build.build_native_image() == out
    lib = ctypes.CDLL(str(out))
    lib.fi_decode_crop_resize.restype = ctypes.c_int
    lib.fi_decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (60, 80, 3), np.uint8)).save(
        buf, "JPEG", quality=90)
    data = buf.getvalue()
    got = np.empty((32, 32, 3), np.uint8)
    assert lib.fi_decode_crop_resize(data, len(data), 5, 4, 50, 40,
                                     got.ctypes.data_as(ctypes.c_void_p), 32, 32) == 0
    want = native.decode_crop_resize(data, (5, 4, 50, 40), 32)
    assert want is not None
    np.testing.assert_array_equal(got, want)
