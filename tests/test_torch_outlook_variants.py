"""The port's two outlook formulations that only `scripts/bench_outlook.py`
runs, against the JAX package's on the same inputs (numpy seeds, f32):
`outlook_attention_blockdiag` at group 4 on 16 tokens and its fallback at
group 7 on 9 tokens, and `outlook_attention_cvjp`, whose backward is written
by hand in both packages. Outputs within rtol 2e-5 / atol 2e-6, the
gradients of sum(out^2) within rtol 2e-4 / atol 2e-5: the tolerances of
tests/test_outlook_pallas.py for the same functions against JAX's autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoprog_tpu.ops import outlook as jax_outlook
from autoprog_tpu_torch.ops import outlook as port_outlook

OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

#: (function, extra keywords, B, H = W, C, heads, seed)
CASES = {
    "blockdiag_g4": ("outlook_attention_blockdiag", {"group": 4}, 2, 8, 16, 4, 3),
    "blockdiag_g7_fallback": ("outlook_attention_blockdiag", {"group": 7}, 1, 6, 8, 2, 4),
    "cvjp": ("outlook_attention_cvjp", {}, 2, 8, 16, 4, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outlook_variant_equals_the_jax_function(case):
    name, extra, B, H, C, heads, seed = CASES[case]
    rs = np.random.RandomState(seed)
    v = rs.randn(B, H, H, C).astype(np.float32)
    logits = rs.randn(B, H // 2, H // 2, heads * 81).astype(np.float32)
    kw = dict(num_heads=heads, kernel_size=3, stride=2, padding=1,
              scale=(C // heads) ** -0.5, **extra)
    jfn = getattr(jax_outlook, name)

    def jloss(a, b):
        return jnp.sum(jfn(a, b, **kw) ** 2)
    want = np.asarray(jfn(jnp.asarray(v), jnp.asarray(logits), **kw))
    jgv, jgl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(logits))

    tv = torch.from_numpy(v).requires_grad_(True)
    tl = torch.from_numpy(logits).requires_grad_(True)
    out = getattr(port_outlook, name)(tv, tl, **kw)
    out.pow(2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), **GRAD_TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), **GRAD_TOL)


def test_cvjp_runs_its_own_backward():
    """The custom backward is the one autograd calls (not autodiff of the
    forward), and it equals autodiff of `outlook_attention` in f32."""
    rs = np.random.RandomState(1)
    v = torch.from_numpy(rs.randn(1, 8, 8, 16).astype(np.float32))
    logits = torch.from_numpy(rs.randn(1, 4, 4, 4 * 81).astype(np.float32))
    kw = dict(num_heads=4, kernel_size=3, stride=2, padding=1, scale=0.5)
    a = v.clone().requires_grad_(True)
    out = port_outlook.outlook_attention_cvjp(a, logits, **kw)
    assert type(out.grad_fn).__name__ == "_OutlookCvjpBackward"
    b = v.clone().requires_grad_(True)
    ref = port_outlook.outlook_attention(b, logits, **kw)
    g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **GRAD_TOL)
