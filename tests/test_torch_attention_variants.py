"""K5 (`mhsa_fused` on separate q, k, v) and the schedule variants S1 / S2 of
autoprog_tpu_torch against the Pallas kernels of the JAX package, run in
interpret mode on the CPU.

On the CPU the port's wrappers run their plain twins, which round at the
Pallas kernels' points. Inputs come from a numpy seed and go through both
packages. Tolerance: f32 rtol/atol 1e-5 (summation order only); bf16 2 ulp of
the largest |value| (2^-6 relative), since another summation order can flip
one rounding to bf16. The CUDA kernels themselves are checked against the
twins on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from autoprog_tpu.ops import attention_pallas as ap
from autoprog_tpu_torch.ops import attention as A
from autoprog_tpu_torch.scripts import attn_variants as V
from autoprog_tpu_torch.scripts import bench_attn, bench_attn_x as X, bench_k1
from scripts import attn_variants as jax_variants
from scripts import bench_attn_x as jax_x

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def both(arr, dtype):
    return jnp.asarray(arr, JDT[dtype]), torch.from_numpy(arr).to(dtype)


def assert_close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 2.0 ** -6 * max(1.0, np.abs(ref).max())


# ------------------------------------------------------------------- K5

SPLIT_CASES = [(16, 2, 8), (25, 3, 16), (25, 2, 8)]        # n, heads, d


def split_inputs(n, heads, d, seed, dtype):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(2, n, heads, d).astype(np.float32) for _ in range(4)]
    pairs = [both(a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads,d", SPLIT_CASES)
def test_mhsa_fused_twin_forward_matches_pallas(dtype, n, heads, d):
    (jq, jk, jv, _), (tq, tk, tv, _) = split_inputs(n, heads, d, n + d, dtype)
    scale = d ** -0.5
    ref = ap.mhsa_fused(jq, jk, jv, scale, True)
    got = A.mhsa_fused(tq, tk, tv, scale)
    assert got.dtype == dtype and got.is_contiguous()
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads,d", SPLIT_CASES)
def test_mhsa_fused_twin_grads_match_pallas(dtype, n, heads, d):
    """The autograd Function's CPU backward against the Pallas custom_vjp."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = split_inputs(n, heads, d, 3 * n + d, dtype)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: ap.mhsa_fused(q, k, v, scale, True), jq, jk, jv)
    refs = vjp(jg)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    A.mhsa_fused(*leaves, scale).backward(tg)
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == dtype
        assert_close(leaf.grad, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads,d", SPLIT_CASES + [(100, 2, 32), (197, 1, 64), (272, 1, 32)])
def test_mhsa_fused_twins_with_statistics(dtype, n, heads, d):
    """K5's forward twin returns (rowmax, z) and its backward twin takes them:
    exactly the twins without, and the Pallas kernels' results."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = split_inputs(n, heads, d, 5 * n + d, dtype)
    scale = d ** -0.5
    out, stats = A.mhsa_fused_reference(tq, tk, tv, scale, return_stats=True)
    assert stats.shape == (2, heads, n, 2) and stats.dtype == torch.float32
    assert torch.equal(out, A.mhsa_fused_reference(tq, tk, tv, scale))
    grads = A.mhsa_fused_backward_reference(tq, tk, tv, tg, scale, stats)
    for got, plain in zip(grads, A.mhsa_fused_backward_reference(tq, tk, tv, tg, scale)):
        assert torch.equal(got, plain)
    ref_out, vjp = jax.vjp(lambda q, k, v: ap.mhsa_fused(q, k, v, scale, True), jq, jk, jv)
    assert_close(out, ref_out, dtype)
    for got, ref in zip(grads, vjp(jg)):
        assert_close(got, ref, dtype)


def test_mhsa_fused_function_hands_the_statistics_to_its_backward(monkeypatch):
    (_, _, _, _), (tq, tk, tv, tg) = split_inputs(25, 2, 8, 4, torch.bfloat16)
    seen = {}
    fwd, bwd = A.mhsa_fused_reference, A.mhsa_fused_backward_reference

    def spy_fwd(q, k, v, scale, return_stats=False):
        seen.setdefault("return_stats", []).append(return_stats)
        return fwd(q, k, v, scale, return_stats)

    def spy_bwd(q, k, v, dout, scale, stats=None):
        seen["stats"] = stats
        return bwd(q, k, v, dout, scale, stats)

    monkeypatch.setattr(A, "mhsa_fused_reference", spy_fwd)
    monkeypatch.setattr(A, "mhsa_fused_backward_reference", spy_bwd)
    A.mhsa_fused(tq, tk, tv, 0.3)                          # no gradient wanted
    tk.requires_grad_(True)                                # one operand is enough
    A.mhsa_fused(tq, tk, tv, 0.3).backward(tg)
    assert seen["return_stats"] == [False, True]
    assert torch.equal(seen["stats"], fwd(tq, tk.detach(), tv, 0.3, True)[1])
    assert torch.equal(tk.grad, bwd(tq, tk.detach(), tv, tg, 0.3)[1])


def test_mhsa_fused_takes_the_views_of_a_qkv_buffer():
    """q, k, v as the three views of a [B, n, 3, heads, d] buffer (what the
    bench's boundary row passes) give what contiguous copies give, and what
    K1 gives at f32 scores."""
    B, n, heads, d = 2, 25, 3, 8
    qkv = torch.from_numpy(np.random.RandomState(0).randn(B, n, 3 * heads * d)
                           .astype(np.float32)).bfloat16()
    q, k, v = bench_attn.split_qkv(qkv, heads)
    assert not q.is_contiguous() and q.stride(3) == 1
    A._check_split_cuda(q, ("k", k), ("v", v))            # the launch would take them
    out = A.mhsa_fused(q, k, v, d ** -0.5)
    assert torch.equal(out, A.mhsa_fused(q.contiguous(), k.contiguous(), v.contiguous(),
                                         d ** -0.5))
    assert torch.equal(out.reshape(B, n, heads * d),
                       A.mhsa_fused_qkv(qkv, heads, d ** -0.5, scores_f32=True))


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 8, 2, 16).transpose(2, 3),) * 3, "last axis"),
    (lambda: (torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 8), torch.zeros(2, 8, 2, 16)),
     "does not match"),
    (lambda: (torch.zeros(2, 8, 2, 16, dtype=torch.float16),) * 3, "dtype"),
    (lambda: (torch.zeros(2, 1025, 1, 8),) * 3, "limits"),
    (lambda: (torch.zeros(2, 8, 1, 256),) * 3, "limits"),
    (lambda: (torch.zeros(2, 8, 16),) * 3, r"\[B, n, heads, d\]"),
])
def test_mhsa_fused_launch_checks_refuse_what_the_kernel_does_not_take(make, match):
    q, k, v = make()
    with pytest.raises(ValueError, match=match):
        A._check_split_cuda(q, ("k", k), ("v", v))


def test_cpu_twins_count_no_launches():
    before = dict(A.LAUNCHES), dict(V.LAUNCHES), dict(X.LAUNCHES)
    x = torch.randn(2, 16, 3 * 2 * 8).requires_grad_(True)
    q, k, v = bench_attn.split_qkv(x, 2)
    A.mhsa_fused(q, k, v, 0.3).sum().backward()
    V.mhsa_variant_with_shared_bwd("pipelined")(x, 2, 0.3).sum().backward()
    X.make_variant("phase", 2, 2, 0.3)(x).sum().backward()
    assert (dict(A.LAUNCHES), dict(V.LAUNCHES), dict(X.LAUNCHES)) == before
    assert set(A.LAUNCHES) == {"fwd", "bwd", "fused_fwd", "fused_bwd"}


# ------------------------------------------------------------------- S2

def qkv_inputs(n, heads, d, seed, B=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, n, 3 * heads * d).astype(np.float32)
    g = rs.randn(B, n, heads * d).astype(np.float32)
    return both(x, torch.bfloat16) + both(g, torch.bfloat16)


def test_variant_names_are_the_jax_ones():
    assert list(V._KERNELS) == list(jax_variants._KERNELS)
    assert V.SCORES_F32 == {"twophase": True, "twophase_bf16s": False, "pipelined": True}


@pytest.mark.parametrize("name", list(V._KERNELS))
@pytest.mark.parametrize("n,heads,d", [(16, 2, 8), (25, 3, 16)])
def test_variant_twin_forward_matches_pallas(name, n, heads, d):
    jx, tx, _, _ = qkv_inputs(n, heads, d, n)
    scale = d ** -0.5
    ref = jax_variants.mhsa_fwd_variant(name, jx, heads, scale, interpret=True)
    got = V.mhsa_fwd_variant(name, tx, heads, scale)
    assert got.dtype == torch.bfloat16
    assert_close(got, ref, torch.bfloat16)
    assert torch.equal(got, V.mhsa_fwd_variant_reference(name, tx, heads, scale))


@pytest.mark.parametrize("name", list(V._KERNELS))
def test_variant_with_shared_bwd_grads_match_pallas(name, monkeypatch):
    """Variant forward + K1's backward at its default score type, as the JAX
    script pairs them."""
    monkeypatch.delenv("AUTOPROG_ATTN_SCORES_F32", raising=False)
    n, heads, d = 25, 2, 16
    jx, tx, jg, tg = qkv_inputs(n, heads, d, 7)
    scale = d ** -0.5
    jfn = jax_variants.mhsa_variant_with_shared_bwd(name)
    ref_out, vjp = jax.vjp(lambda x: jfn(x, heads, scale, True), jx)
    (ref,) = vjp(jg)
    tx.requires_grad_(True)
    out = V.mhsa_variant_with_shared_bwd(name)(tx, heads, scale)
    out.backward(tg)
    assert_close(out.detach(), ref_out, torch.bfloat16)
    assert_close(tx.grad, ref, torch.bfloat16)


def test_variant_refuses_unknown_names_and_other_dtypes():
    x = torch.zeros(2, 16, 3 * 16)
    with pytest.raises(KeyError, match="unknown variant"):
        V.mhsa_fwd_variant("threephase", x, 2, 0.3)
    with pytest.raises(KeyError, match="unknown variant"):
        V.mhsa_variant_with_shared_bwd("threephase")
    with pytest.raises(ValueError, match="bfloat16"):
        V.check_bf16_qkv("variant", x, 2)


# ------------------------------------------------------------------- S1

def pallas_group(body, G, heads, scale, *arrays, out_c):
    """`make_variant` of the JAX script takes no `interpret`: the same
    pallas_call around the script's kernel bodies, in interpret mode."""
    B, n, _ = arrays[0].shape

    def spec(c):
        return pl.BlockSpec((G, n, c), lambda b: (b, 0, 0))

    return pl.pallas_call(
        functools.partial(body, scale, heads, G),
        out_shape=jax.ShapeDtypeStruct((B, n, out_c), arrays[0].dtype),
        grid=(B // G,), in_specs=[spec(a.shape[2]) for a in arrays],
        out_specs=spec(out_c), interpret=True)(*arrays)


GROUP_CASES = [("phase", 1), ("phase", 2), ("loop", 2), ("loop", 4), ("phase", 4)]


@pytest.mark.parametrize("order,G", GROUP_CASES)
@pytest.mark.parametrize("n,heads,d", [(16, 2, 8), (25, 3, 16)])
def test_group_variant_forward_and_backward_match_pallas(order, G, n, heads, d):
    jx, tx, jg, tg = qkv_inputs(n, heads, d, 11 * G + n, B=4)
    scale = d ** -0.5
    C = heads * d
    fwd_body = jax_x._fwd_phase_kernel if order == "phase" else jax_x._fwd_loop_kernel
    ref_out = pallas_group(fwd_body, G, heads, scale, jx, out_c=C)
    ref_grad = pallas_group(jax_x._bwd_phase_kernel, G, heads, scale, jx, jg, out_c=3 * C)
    tx.requires_grad_(True)
    out = X.make_variant(order, G, heads, scale)(tx)
    out.backward(tg)
    assert_close(out.detach(), ref_out, torch.bfloat16)
    assert_close(tx.grad, ref_grad, torch.bfloat16)
    # the variants never round the scores: K1 at f32 scores, bit for bit
    assert torch.equal(out.detach(), A.mhsa_fused_qkv(tx.detach(), heads, scale, True))


def test_group_variant_refuses_a_batch_it_cannot_split_and_unknown_orders():
    x = torch.zeros(3, 16, 3 * 16)
    with pytest.raises(ValueError, match="multiple of G=2"):
        X.make_variant("loop", 2, 2, 0.3)(x)
    with pytest.raises(ValueError, match="order"):
        X.make_variant("spiral", 2, 2, 0.3)


def test_table_variants_are_the_jax_table():
    names = list(X.table_variants(128, 12, 0.3))
    assert names == ["base (mhsa_fused_qkv)", "base, f32 scores", "phase_img1",
                     "phase_img2", "loop_img2", "phase_img4", "loop_img4"]
    assert "phase_img2" not in X.table_variants(3, 12, 0.3)


# --------------------------------------------------------------- the tables

def test_bench_attn_x_prints_its_table_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    rows = X.main(["2"])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows][2:] == ["phase_img1", "phase_img2", "loop_img2"]
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in rows)
    assert all(r["fwd_equal"] and r["bwd_equal"] for r in rows[1:])
    assert "on cpu" in out and "loop_img2" in out


def test_bench_attn_prints_its_tables_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    rows = bench_attn.main(["2"])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == [
        "unfused f32 logits", "unfused bf16 logits", "mhsa_fused",
        "qkv: unfused bf16 logits", "qkv: mhsa_fused (boundary)", "qkv: mhsa_fused_qkv",
        "qkv: variant twophase", "qkv: variant twophase_bf16s", "qkv: variant pipelined"]
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in rows)
    assert "flash" not in out


def test_bench_k1_prints_its_table_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("AUTOPROG_TORCH_DEVICE", "cpu")
    rows = bench_k1.main([])
    out = capsys.readouterr().out
    assert [(r["n"], r["heads"], r["d"]) for r in rows] == [
        (64, 12, 32), (100, 12, 32), (144, 12, 32), (196, 12, 32), (197, 6, 64)]
    assert all(r[c] > 0 for r in rows for c in bench_k1.COLUMNS)
    assert "on cpu" in out and "first bwd" in out


def test_bench_k1_times_further_calls_in_the_same_turns():
    qkv, dout = bench_k1.inputs(2, 16, 2, 8, torch.device("cpu"))
    calls = []
    ms = bench_k1.time_shape(qkv, dout, 2, iters=1, repeats=2,
                             extra={"yardstick": lambda: calls.append(1)})
    assert set(ms) == set(bench_k1.COLUMNS) | {"yardstick"}
    assert ms["yardstick"] >= 0 and len(calls) == 2           # no warm-up on the CPU


def test_the_benches_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.delenv("AUTOPROG_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (X.main, bench_attn.main, bench_k1.main):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            main(["2"])


def test_unfused_formulations_agree_with_the_fused_twin():
    """The bench's two unfused paths and K5's twin compute the same attention
    (bf16: they round at other points; 2^-5 of the largest value)."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 25, 2, 16).astype(np.float32)).bfloat16()
               for _ in range(3))
    ref = A.mhsa_fused_reference(q, k, v, 0.25).float()
    for fn in (bench_attn.attn_unfused_f32, bench_attn.attn_unfused_bf16):
        assert (fn(q, k, v, 0.25).float() - ref).abs().max() <= 2.0 ** -5 * ref.abs().max()
