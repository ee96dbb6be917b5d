"""Port parity of the train step's options, piece by piece, against the JAX
package on the CPU (inputs from numpy seeds, f32):

  * `sparse_token_label_target` (AUTOPROG_SPARSE_TL=1) on the stored grid
    and on resized grids, with and without a mixed ground-truth row: the
    dicts within 1e-6;
  * both token-label losses on sparse targets: against JAX's (1e-6
    relative), and against the port's dense path, loss and input gradients
    (1e-5);
  * `jsd_cross_entropy` (`--jsd`): 1e-6 relative;
  * the stochastic bf16 rounding on a given dither: bit for bit, carries
    across binades, NaN and inf included; statistically, that the cast is
    unbiased and that a bf16 EMA at d = 0.9999 tracks its target where a
    round-to-nearest one freezes;
  * `normalize_uint8` exactly; `random_erase` on JAX's own draws exactly;
  * AdamW with a bf16 first moment against optax `mu_dtype=bfloat16`: the
    moment bit for bit, parameters 1e-6; Nesterov SGD with decoupled weight
    decay against the optax chain, two steps, 1e-6.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoprog_tpu import losses as jlosses
from autoprog_tpu.data import token_label as jtl
from autoprog_tpu.ops import erase as jerase
from autoprog_tpu.ops import rounding as jround
from autoprog_tpu.train import optim as joptim
from autoprog_tpu_torch import losses as tlosses
from autoprog_tpu_torch.convert import flax_to_torch
from autoprog_tpu_torch.data import token_label as ttl
from autoprog_tpu_torch.ops import erase as terase
from autoprog_tpu_torch.ops import rounding as tround
from autoprog_tpu_torch.train import optim as toptim

C, K = 12, 5


def _map(seed, B=3, H=14):
    rs = np.random.default_rng(seed)
    scores = rs.random((B, K, H, H)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True) * 1.25
    # few classes, so that the taps of one token repeat class indices
    inds = rs.integers(0, C, (B, K, H, H)).astype(np.int32)
    labels = rs.integers(0, C, B).astype(np.int32)
    gt = rs.random((B, C)).astype(np.float32)
    return labels, scores, inds, gt / gt.sum(1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gt_soft", [False, True])
@pytest.mark.parametrize("n", [14, 8, 4])
def test_sparse_target_matches_jax(n, gt_soft):
    labels, scores, inds, gt = _map(n)
    kw = dict(num_classes=C, smoothing=0.1, label_size=n)
    want = jtl.sparse_token_label_target(jnp.asarray(labels), jnp.asarray(scores),
                                         jnp.asarray(inds), **kw,
                                         gt_soft=jnp.asarray(gt) if gt_soft else None)
    got = ttl.sparse_token_label_target(_t(labels), _t(scores), _t(inds), **kw,
                                        gt_soft=_t(gt) if gt_soft else None)
    assert set(got) == set(want) == {"gt", "cls", "vals", "inds", "u"}
    assert got["vals"].shape == (3, n * n, K if n == 14 else 4 * K)
    np.testing.assert_array_equal(got["inds"].numpy(), np.asarray(want["inds"]))
    for key in ("gt", "cls", "vals", "u"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def _outputs(seed, B, N, requires_grad=False):
    rs = np.random.default_rng(seed)
    x_cls = torch.tensor(rs.normal(size=(B, C)).astype(np.float32), requires_grad=requires_grad)
    x_aux = torch.tensor(rs.normal(size=(B, N, C)).astype(np.float32),
                         requires_grad=requires_grad)
    g = int(np.sqrt(N)) // 2
    bbox = torch.tensor([1, 1, 1 + g, 2 + g], dtype=torch.int32)
    return x_cls, x_aux, bbox


@pytest.mark.parametrize("n", [14, 8])
@pytest.mark.parametrize("ground_truth", [False, True])
def test_sparse_losses_match_jax_and_the_dense_path(ground_truth, n):
    labels, scores, inds, _ = _map(7 + n)
    kw = dict(num_classes=C, smoothing=0.1, label_size=n)
    args = argparse.Namespace(token_label=True, token_label_size=n, ground_truth=ground_truth,
                              dense_weight=0.5, cls_weight=1.0, jsd=False, aug_splits=0)
    jloss, tloss = jlosses.build_train_loss(args), tlosses.build_train_loss(args)
    assert jloss.supports_sparse_tl and tloss.supports_sparse_tl
    x_cls, x_aux, bbox = _outputs(n, 3, n * n)
    jt = jtl.sparse_token_label_target(jnp.asarray(labels), jnp.asarray(scores),
                                       jnp.asarray(inds), **kw)
    want = float(jloss((jnp.asarray(x_cls.numpy()), jnp.asarray(x_aux.numpy()),
                        jnp.asarray(bbox.numpy())), jt))
    sparse = ttl.sparse_token_label_target(_t(labels), _t(scores), _t(inds), **kw)
    assert float(tloss((x_cls, x_aux, bbox), sparse)) == pytest.approx(want, rel=1e-6)

    dense = ttl.build_token_label_target(_t(labels), _t(scores), _t(inds), **kw)
    grads = []
    for target in (sparse, dense):
        xc, xa, _ = _outputs(n, 3, n * n, requires_grad=True)
        loss = tloss((xc, xa, bbox), target)
        loss.backward()
        grads.append((float(loss.detach()), xc.grad, xa.grad))
    (ls, gcs, gas), (ld, gcd, gad) = grads
    assert ls == pytest.approx(ld, rel=1e-5)
    np.testing.assert_allclose(gcs.numpy(), gcd.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gas.numpy(), gad.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("splits", [2, 3])
def test_jsd_loss_matches_jax(splits):
    rs = np.random.default_rng(splits)
    B = 4
    logits = rs.normal(size=(splits * B, C)).astype(np.float32) * 3
    labels = rs.integers(0, C, B).astype(np.int32)
    args = argparse.Namespace(jsd=True, aug_splits=splits, smoothing=0.1, num_classes=C,
                              token_label=False)
    jfn, tfn = jlosses.build_train_loss(args), tlosses.build_train_loss(args)
    assert jfn.wants_int_labels and tfn.wants_int_labels
    want = float(jfn(jnp.asarray(logits), jnp.asarray(labels)))
    assert float(tfn(_t(logits), _t(labels))) == pytest.approx(want, rel=1e-6)
    # the cls logits of a tuple output
    assert float(tfn((_t(logits), None), _t(labels))) == pytest.approx(want, rel=1e-6)


def _edge_values():
    f32 = np.float32
    vals = [1.0, -1.0, 0.0, -0.0, np.inf, -np.inf, np.nan,
            np.finfo(f32).max, -np.finfo(f32).max, np.finfo(f32).tiny, 1e-40,
            # the largest f32 below a power of two: any dither carries out of
            # the mantissa into the exponent (the next binade)
            np.nextafter(f32(2.0), f32(0)), -np.nextafter(f32(0.5), f32(0)),
            # an exact bf16 value with a mantissa of ones
            f32(np.float32(1.9921875))]
    x = np.asarray(vals, np.float32)
    dither = np.asarray([0, 0xFFFF, 0x8000, 1, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF,
                         0x7FFF, 0xFFFF, 1, 0xFFFF, 0xFFFF], np.uint32)
    return x, dither


@pytest.mark.parametrize("case", ["random", "edges"])
def test_sr_with_dither_is_jax_s_bit_for_bit(case):
    if case == "random":
        rs = np.random.default_rng(0)
        x = (rs.normal(size=4096) * np.exp(rs.uniform(-20, 20, 4096))).astype(np.float32)
        dither = rs.integers(0, 1 << 16, x.shape).astype(np.uint32)
    else:
        x, dither = _edge_values()
    want = np.asarray(jround._sr_bf16_with_dither(jnp.asarray(x), jnp.asarray(dither)))
    got = tround.sr_bf16_with_dither(_t(x), _t(dither.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    if case == "edges":
        out = got.float().numpy()
        assert np.isnan(out[6]) and out[4] == np.inf and out[5] == -np.inf
        assert out[11] == 2.0          # nextafter(2, 0) + 1: carried into 2.0


def test_sr_cast_shares_one_sweep_and_is_unbiased():
    """Every tensor reads a prefix of one dither sweep per call; each result
    is one of the two bf16 neighbours of x, and the mean over many calls
    recovers x (as JAX's test_sr_cast_unbiased_and_adjacent)."""
    rs = np.random.default_rng(0)
    x = torch.tensor(rs.normal(size=512).astype(np.float32) * 0.3)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    a, b = tround.cast_bf16_sr([x, x[:100].reshape(10, 10)], gen)
    assert b.shape == (10, 10)
    assert torch.equal(a[:100].reshape(10, 10), b)         # the same prefix of one sweep
    gen.set_state(state)
    dither = torch.randint(0, 1 << 16, (512,), dtype=torch.int32, generator=gen)
    assert torch.equal(a, tround.sr_bf16_with_dither(x, dither))
    outs = torch.stack([tround.cast_bf16_sr([x], gen)[0].float() for _ in range(256)])
    ulp = x.bfloat16().float().abs() * 2.0 ** -7 + 1e-30
    assert float(((outs - x).abs() / ulp).max()) <= 1.0 + 1e-3
    assert float(((outs.mean(0) - x).abs() / ulp).mean()) < 0.25


def test_bf16_ema_at_0_9999_does_not_freeze():
    """The train step's bf16 EMA (`StepBuilder._update_ema`): 40000 steps at
    d = 0.9999 towards parameters at 1.02 from 1.0. The f32 EMA's value is
    1 + 0.02 (1 - d^40000); the stochastically rounded bf16 trees track it,
    where round to nearest stays at 1.0 (its increments are below half a
    bf16 ulp)."""
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    d, steps = 0.9999, 40000
    model = torch.nn.Linear(16, 16)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.0)
    state = TrainState.create(model=model, optimizer=None, ema_decays=(d,),
                              ema_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.02)
    sb = StepBuilder(train_loss=None, ema_decays=(d,), seed=3)
    params = [p.detach() for p in model.parameters()]
    nearest = torch.ones(272, dtype=torch.bfloat16)
    for _ in range(steps):
        sb._update_ema(state, params)
        nearest = (nearest.float() * d + 1.02 * (1 - d)).bfloat16()
    want = 1.0 + 0.02 * (1.0 - d ** steps)
    ema = torch.cat([t.flatten() for t in state.ema_params[0].values()])
    assert ema.dtype == torch.bfloat16 and ema.numel() == 272
    assert torch.all(nearest == 1.0)
    assert abs(float(ema.float().mean()) - want) < 2e-3


def test_normalize_uint8_is_jax_s_exactly():
    rs = np.random.default_rng(0)
    img = rs.integers(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = np.asarray(jerase.normalize_uint8(jnp.asarray(img), mean, std, jnp.float32))
    got = terase.normalize_uint8(_t(img), mean, std, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert terase.normalize_uint8(_t(img), mean, std, torch.bfloat16).dtype == torch.bfloat16


def _jax_draws(rng, shape, prob, count, area=(0.02, 1 / 3), aspect=(0.3, 10 / 3)):
    """`autoprog_tpu/ops/erase.py:random_erase`'s draws, redrawn from its keys."""
    B, H, W, _ = shape
    draws = []
    for k in range(count):
        ks = jax.random.split(jax.random.fold_in(rng, k), 6)
        u = lambda key, lo=0.0, hi=1.0: jax.random.uniform(key, (B,), minval=lo, maxval=hi)
        draws.append(tuple(_t(v) for v in (
            u(ks[0]) < prob, u(ks[1], area[0], area[1]) * (H * W),
            u(ks[2], jnp.log(aspect[0]), jnp.log(aspect[1])), u(ks[3]), u(ks[4]),
            jax.random.normal(ks[5], shape, jnp.float32))))
    return draws


@pytest.mark.parametrize("prob,count", [(1.0, 1), (0.5, 1), (0.7, 3)])
def test_random_erase_on_jax_s_draws_is_jax_s_exactly(prob, count):
    shape = (16, 24, 20, 3)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    rng = jax.random.PRNGKey(count)
    want = np.asarray(jerase.random_erase(jnp.asarray(x), rng, prob=prob, count=count))
    got = terase.apply_erase(_t(x), _jax_draws(rng, shape, prob, count))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != x).any()


def test_random_erase_draws_boxes_of_the_configured_size():
    """The port's own draws (Philox, not threefry): at prob 1 every image is
    erased over a share of its area within the configured range; at prob 0
    nothing changes; the same generator state gives the same boxes."""
    x = torch.zeros(64, 24, 24, 3)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    out = terase.random_erase(x, gen, prob=1.0)
    share = (out != 0).float().mean(dim=(1, 2, 3))
    assert bool((share > 0).all()) and 0.01 < float(share.mean()) < 0.5
    assert float(share.max()) <= 1 / 3 * 1.5
    gen.set_state(state)
    assert torch.equal(terase.random_erase(x, gen, prob=1.0), out)
    assert torch.equal(terase.random_erase(x, gen, prob=0.0), x)


def _module(tree):
    module = torch.nn.Module()
    for name, v in flax_to_torch(tree).items():
        parent = module
        *path, leaf = name.split(".")
        for p in path:
            if not hasattr(parent, p):
                parent.add_module(p, torch.nn.Module())
            parent = getattr(parent, p)
        parent.register_parameter(leaf, torch.nn.Parameter(v.clone()))
    return module


def _opt_args(**kw):
    d = dict(opt="adamw", opt_eps=1e-6, opt_betas=[0.9, 0.95], momentum=0.9,
             weight_decay=0.05, clip_grad=None, clip_mode="norm", adam_mu_bf16=False)
    d.update(kw)
    return argparse.Namespace(**d)


def _run_both(args, steps):
    """`steps` updates of the optax chain and of the port's optimizer on the
    same gradients; yields (torch module, optimizer, jax params, opt state)
    after each."""
    rs = np.random.default_rng(0)
    shapes = {"pos_embed": (1, 2, 2, 4), "fc": {"kernel": (4, 3), "bias": (3,)},
              "conv": {"kernel": (3, 3, 2, 4)}, "norm": {"scale": (4,)}}
    tree = jax.tree.map(lambda s: rs.normal(size=s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    jparams = jax.tree.map(jnp.asarray, tree)
    tx = joptim.create_optimizer(args, jparams)
    opt_state = tx.init(jparams)
    module = _module(tree)
    opt = toptim.create_optimizer(args, module)
    for step in range(steps):
        grads = jax.tree.map(lambda x: (rs.normal(size=x.shape) * 10 ** rs.uniform(-3, 1, x.shape)
                                        ).astype(np.float32), tree)
        lr = 1e-2 * (step + 1)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, joptim.apply_lr(upd, lr))
        tgrads = flax_to_torch(grads)
        for name, p in module.named_parameters():
            p.grad = tgrads[name].clone()
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        yield module, opt, jparams, opt_state


def _by_name(module, opt, key):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: s[key] for p, s in opt.state.items()}


@pytest.mark.parametrize("opt", ["adamw", "adam"])
def test_adamw_with_a_bf16_first_moment_matches_optax(opt):
    args = _opt_args(opt=opt, adam_mu_bf16=True)
    for module, topt, jparams, jstate in _run_both(args, 3):
        assert isinstance(topt, toptim.AdamWBf16Mu)
        adam = next(s for s in jstate if hasattr(s, "mu"))
        mu = _by_name(module, topt, "exp_avg")
        want = flax_to_torch(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), adam.mu))
        assert {t.dtype for t in mu.values()} == {torch.bfloat16}
        for n, t in want.items():
            assert torch.equal(mu[n].float(), t), n
        got = dict(module.named_parameters())
        for n, t in flax_to_torch(jparams).items():
            np.testing.assert_allclose(got[n].detach().numpy(), t.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=n)


@pytest.mark.parametrize("opt,wd", [("sgd", 0.05), ("momentum", 0.05), ("sgd", 0.0)])
def test_nesterov_sgd_with_decoupled_decay_matches_the_optax_chain(opt, wd):
    args = _opt_args(opt=opt, weight_decay=wd)
    for module, topt, jparams, jstate in _run_both(args, 2):
        assert isinstance(topt, toptim.NesterovSGD)
        assert [g["weight_decay"] for g in topt.param_groups] == [wd, 0.0]
        trace = next(s for s in jstate if hasattr(s, "trace")).trace
        bufs = _by_name(module, topt, "momentum_buffer")
        for n, t in flax_to_torch(jax.tree.map(np.asarray, trace)).items():
            np.testing.assert_allclose(bufs[n].numpy(), t.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=n)
        got = dict(module.named_parameters())
        for n, t in flax_to_torch(jparams).items():
            np.testing.assert_allclose(got[n].detach().numpy(), t.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=n)
