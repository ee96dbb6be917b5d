"""autoprog_tpu_torch: the PyTorch / CUDA port of autoprog_tpu.

The fixed trainer (`python -m autoprog_tpu_torch.main`) trains VOLO on one
NVIDIA H100, with the fused-qkv MHSA forward and backward as hand-written
CUDA kernels (`csrc/mhsa_qkv.cu`, built with nvcc at first use). The JAX
package `autoprog_tpu` is the reference each module is tested against; the
port imports its jax-free host modules (config, data pipeline, schedules'
host helpers, logging) and never imports jax itself.

Module names mirror the JAX package: `ops/outlook.py` is the counterpart of
`autoprog_tpu/ops/outlook.py`, and so on.
"""

__version__ = "0.1.0"

from autoprog_tpu_torch.registry import create_model, list_models, register_model  # noqa: F401
