"""Measurement scripts of the port, counterparts of the JAX package's
`scripts/bench_attn.py`, `scripts/bench_attn_x.py` and
`scripts/attn_variants.py`. Each runs as
`python -m autoprog_tpu_torch.scripts.<name> [B]` on the card, or on the CPU
at a small size when AUTOPROG_TORCH_DEVICE=cpu asks for it."""
