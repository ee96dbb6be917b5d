"""Faults planted under the timed path, for the calibration (`calibrate.py`)
and the tests that see `correct` come out false. The benchmark's runs never
plant one.

  * `frozen`: the step computes its loss and leaves the state unchanged;
  * `half_batch`: the step trains on the first half of its rows, the loss
    the mean over them;
  * `no_allreduce`: across chips, the gradient all-reduce is left out, so
    each rank steps on its own rows' gradient.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "half_batch", "no_allreduce")


def _half(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        out[k] = v[: v.shape[0] // 2] if hasattr(v, "shape") else v
    return out


@contextlib.contextmanager
def planted(name: str):
    """Plant fault `name` for the duration of the block."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    from benchmark import program
    if name == "no_allreduce":
        from autoprog_tpu_torch.parallel import mesh
        saved = mesh.all_reduce_grads
        mesh.all_reduce_grads = lambda params: None
        try:
            yield
        finally:
            mesh.all_reduce_grads = saved
        return
    saved = program.Program.step

    def frozen(self, batch):
        import torch
        st = self.state
        with torch.no_grad():
            out = st.model(batch["image"], train=True,
                           bbox=None if batch.get("bbox") is None
                           else torch.tensor(batch["bbox"], dtype=torch.int32))
        return self.step_builder.train_loss(out, self.step_builder.build_target(
            batch, self.img_size)).detach()

    def half(self, batch):
        return saved(self, _half(batch))

    program.Program.step = frozen if name == "frozen" else half
    try:
        yield
    finally:
        program.Program.step = saved
