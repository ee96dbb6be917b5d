"""autoprog_tpu_torch: the PyTorch / CUDA port of autoprog_tpu.

The fixed trainer (`python -m autoprog_tpu_torch.main`) and the progressive
trainer with manual growth and the AutoProg search
(`python -m autoprog_tpu_torch.main_prog`) train VOLO on one NVIDIA H100.
The fused-qkv MHSA (`csrc/mhsa_qkv.cu`) and the fused outlook attention with
its attend-only variants (`csrc/outlook.cu`), forward and backward, are
hand-written CUDA kernels, built with nvcc at first use. The JAX package
`autoprog_tpu` is the reference each module is tested against; the port
imports nothing of it and never imports jax: it keeps its own copies of the
host modules (config, data pipeline, schedule and depth helpers, logging).

Module names mirror the JAX package: `ops/outlook.py` is the counterpart of
`autoprog_tpu/ops/outlook.py`, and so on.
"""

__version__ = "0.1.0"

from autoprog_tpu_torch.registry import create_model, list_models, register_model  # noqa: F401
