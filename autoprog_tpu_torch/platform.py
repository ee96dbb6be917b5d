"""Which device the port runs on.

The port's counterpart of `JAX_PLATFORMS`: `AUTOPROG_TORCH_DEVICE` names a
`torch.device` ("cuda", "cuda:1", "cpu"). Unset, the device is `cuda`, or
`cuda:{LOCAL_RANK}` in a process that torchrun started (one rank per card),
and a machine without a usable CUDA device raises rather than carrying on on
the CPU. The CPU runs only when asked for by name (the tests do). Two ranks
share one card when both name it (`AUTOPROG_TORCH_DEVICE=cuda:0`, with the
gloo backend; see parallel/mesh.py).
"""

from __future__ import annotations

import os

import torch

ENV = "AUTOPROG_TORCH_DEVICE"


def default_device() -> torch.device:
    name = os.environ.get(ENV)
    if name is None:
        name = f"cuda:{os.environ['LOCAL_RANK']}" if "LOCAL_RANK" in os.environ else "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"autoprog_tpu_torch needs a CUDA device and none is available; "
            f"set {ENV}=cpu to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{ENV}={dev}: only cuda and cpu devices are supported")
    return dev
