"""The port keeps its own copies of the JAX package's jax-free host modules
(config, logging, meters, the progressive schedule and depth maps, the data
pipeline). Each copy is held to its original on the CPU: equal values, not
approximately."""

import dataclasses
import importlib

import numpy as np
import pytest

# scripts/train_autoprog.sh
FLAGSHIP = ["/data/ImageNet", "--model", "volo_h12_l18", "--img-size", "224", "-b", "1024",
            "--lr", "1.6e-3", "--drop-path", "0.1", "--token-label", "--token-label-size",
            "14", "--token-label-data", "/path/to/token_label_data", "--model-ema",
            "--model-ema-decay", "0.998", "0.9986", "0.999", "0.9996", "--auto-grow",
            "--batch-splits-list", "1", "--search-epochs", "2", "--r-scale", "0.5",
            "--h-scale", "1.", "--l-scale", "0.5", "--aa-scale", "0.5", "--dp-scale", "0.",
            "--re-scale", "0.", "--resize-scale", "1.", "1.", "--num-stages", "4",
            "--epochs", "100", "--load-with-clone-ema"]
FIXED = FLAGSHIP[:FLAGSHIP.index("--auto-grow")] + ["--epochs", "100", "--batch-splits", "2"]


def both(module):
    return (importlib.import_module("autoprog_tpu." + module),
            importlib.import_module("autoprog_tpu_torch." + module))


def outcome(fn, *args):
    """The value, or the error: some grid points are invalid in both."""
    try:
        return fn(*args)
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


def check_parse_args():
    j, t = both("config")
    for argv, prog in ((FLAGSHIP, True), (FIXED, False), (FLAGSHIP[:1], True)):
        (ja, jt), (ta, tt) = j.parse_args(argv, prog=prog), t.parse_args(argv, prog=prog)
        assert vars(ja) == vars(ta) and jt == tt
    for name in ("volo_h12_l18", "volod4_h16_l36", "deit_h3_l12"):
        assert j.parse_variant_name(name) == t.parse_variant_name(name)
    assert j.is_variant_name("volo_d1") == t.is_variant_name("volo_d1")


def check_progressive_schedule():
    j, t = both("prog.schedule")
    for stages in (1, 2, 4):
        for scale in (0.25, 0.5, 1.0):
            kw = dict(num_stages=stages, epochs=300, r_max=224, h_max=12, l_max=18,
                      r_scale=scale, h_scale=1.0, l_scale=scale, aa_scale=0.0, dp_scale=0.0,
                      re_scale=0.0, resize_scale=(1.0, scale), aa_max="rand-m9-mstd0.5-inc1",
                      dp_max=0.1, re_max=0.25, resize_max=(0.08, 1.0))
            assert dataclasses.astuple(j.progressive_schedule(**kw)) == \
                dataclasses.astuple(t.progressive_schedule(**kw))


def check_get_divisor():
    j, t = both("prog.schedule")
    for n in (1, 2, 4, 6, 8):
        for ratio in np.linspace(0.05, 1.0, 20):
            assert j.get_divisor(n, ratio) == t.get_divisor(n, ratio)
    assert j.no_repeats((1, 1, 2, 3, 3)) == t.no_repeats((1, 1, 2, 3, 3))
    assert j.make_divisible(37, 8) == t.make_divisible(37, 8)


def check_elastic_keep_masks():
    j, t = both("prog.depth")
    for l_min, l_max in ((2, 4), (9, 18), (12, 18), (18, 36)):
        for l in range(l_min, l_max + 1):
            assert outcome(j.elastic_keep_masks, l, l_min, l_max) == \
                outcome(t.elastic_keep_masks, l, l_min, l_max)
    assert j.elastic_keep_masks(12, 9, 18) == t.elastic_keep_masks(12, 9, 18)
    for prev, new in ((2, 4), (4, 7), (5, 5)):
        assert j.get_new_layer_idx(prev, new) == t.get_new_layer_idx(prev, new)
        for i in range(new):
            assert j.depth_source_index(i, prev, new) == t.depth_source_index(i, prev, new)
    assert j.volo_depth_split(18) == t.volo_depth_split(18)


def check_super_select_indices():
    j, t = both("prog.depth")
    for base, sup in ((2, 4), (9, 18), (12, 18)):
        for target in range(base, sup + 1):
            assert outcome(j.super_select_indices, base, sup, target) == \
                outcome(t.super_select_indices, base, sup, target)
    assert j.super_select_indices(9, 18, 12) == t.super_select_indices(9, 18, 12)


def check_synthetic_loader():
    (jd, td), (jl, tl), (jm, tm) = both("data.dataset"), both("data.loader"), both("data.mixup")

    def first_batch(d, l, m, training):
        ds = d.create_dataset("", "synthetic://", split="train", is_training=training,
                              token_label_root="synthetic" if training else "",
                              num_classes=10, fake_size=32, image_size=32, seed=3)
        mix = m.Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, num_classes=10,
                      token_label=True) if training else None
        loader = l.create_loader(ds, input_size=32, batch_size=8, is_training=training,
                                 auto_augment="rand-m9-mstd0.5-inc1", re_prob=0.25,
                                 num_workers=0, seed=3, mixup=mix)
        loader.set_epoch(1)
        batch = next(iter(loader))
        loader.close()
        return batch

    for training in (True, False):
        jb, tb = first_batch(jd, jl, jm, training), first_batch(td, tl, tm, training)
        assert set(jb) == set(tb) and "image" in jb
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k


def check_meters():
    j, t = both("utils.meters")
    for cls in ("AverageMeter", "SmoothMeter"):
        a, b = getattr(j, cls)(), getattr(t, cls)()
        for v in (1.0, 2.5, 0.25):
            a.update(v)
            b.update(v)
        assert a.avg == b.avg


def check_native_falls_back_to_pil():
    """Both find the library at the same place beside the packages; with
    AUTOPROG_NO_NATIVE=1 (or the library absent) neither loads it and the
    transforms decode through PIL."""
    import os
    j, t = both("data.native")
    assert j._lib_path() == t._lib_path()
    assert t._lib_path().endswith(os.path.join("native", "libfastimage.so"))
    old = os.environ.get("AUTOPROG_NO_NATIVE")
    os.environ["AUTOPROG_NO_NATIVE"] = "1"
    try:
        assert j.available() is False and t.available() is False
    finally:
        if old is None:
            del os.environ["AUTOPROG_NO_NATIVE"]
        else:
            os.environ["AUTOPROG_NO_NATIVE"] = old


@pytest.mark.parametrize("check", [
    check_parse_args, check_progressive_schedule, check_get_divisor,
    check_elastic_keep_masks, check_super_select_indices, check_synthetic_loader,
    check_meters, check_native_falls_back_to_pil,
], ids=lambda f: f.__name__[6:])
def test_copy_equals_its_original(check):
    check()
