"""Checkpoints, counterpart of `autoprog_tpu/train/checkpoint.py`.

Saving:
  * atomic write (tmp + os.replace) of a `torch.save` payload;
  * `last.ckpt` always current; a hard-linked `keep-<epoch>.ckpt` every
    `NO_DEL_INTERVAL` epochs;
  * top-`max_history` `checkpoint-<epoch>.ckpt` ranked by metric, and a
    `model_best.ckpt` link;
  * batch-level `save_recovery` into `recovery_dir`, `find_recovery`;
  * under a process group only rank 0's saver is `enabled`: it alone builds
    the payload (the callers pass a function that makes it) and writes;
    every rank calls it and waits at a barrier after the write, so that a
    resume on any rank reads a whole file. A disabled saver keeps the same
    ranking. Under tensor parallelism the payload gathers every sharded leaf
    over the model group (`parallel/tp.py`), so the other ranks of rank 0's
    model group build it too, and rank 0 writes full tensors: the file has
    the keys and shapes of a run without it.

The payload carries the architecture name and stage record, parameters,
BatchNorm stats, optimizer state, one EMA tree per decay, the resolved args
YAML, the epoch and the metric.

Loading (`load_checkpoint_file`) reads the port's own files and the JAX
package's: 8 bytes of magic `APTC0001`, the header's length as 8 bytes
little-endian, a JSON header (arch, stage_info, args_text, epoch, metric,
version, batch_idx, step), then flax's msgpack tensors; a file without the
magic is the JAX package's older blob-only format. JAX trees are decoded by
`flax_msgpack` and converted by `convert.jax_payload_to_torch`, so both
come back as the port's payload. `restore_state` installs a payload in a
`TrainState` built for its arch.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from autoprog_tpu_torch.convert import jax_payload_to_torch
from autoprog_tpu_torch.parallel import mesh, tp
from autoprog_tpu_torch.train import flax_msgpack
from autoprog_tpu_torch.train.optim import AdamWBf16Mu, NesterovSGD

CKPT_EXT = ".ckpt"
NO_DEL_INTERVAL = 10   # epochs between kept `keep-<epoch>` snapshots
JAX_MAGIC = b"APTC0001"


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint_file(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """The port's payload from a file of either package (on the CPU)."""
    with open(path, "rb") as f:
        head = f.read(len(JAX_MAGIC))
    if head.startswith(b"PK"):                       # torch.save's zip file
        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(JAX_MAGIC):              # JAX blob-only file
        return jax_payload_to_torch(flax_msgpack.msgpack_restore(data))
    n = int.from_bytes(data[8:16], "little")
    meta = json.loads(data[16:16 + n].decode())
    tree = flax_msgpack.msgpack_restore(memoryview(data)[16 + n:])
    return jax_payload_to_torch({**tree, **meta})


def get_resume_epoch(path: str) -> Optional[int]:
    """The epoch to resume at: the checkpoint holds the completed one."""
    ckpt = load_checkpoint_file(path)
    return int(ckpt["epoch"]) + 1 if "epoch" in ckpt else None


class CheckpointSaver:
    def __init__(self, *, checkpoint_dir: str, recovery_dir: str = "",
                 decreasing: bool = False, max_history: int = 10, enabled: bool = True):
        self.enabled = enabled
        self.checkpoint_dir = checkpoint_dir
        self.recovery_dir = recovery_dir or checkpoint_dir
        self.decreasing = decreasing
        self.max_history = max(1, max_history)
        self.checkpoint_files: List[Tuple[str, float]] = []   # best first
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        if enabled:
            os.makedirs(checkpoint_dir, exist_ok=True)
            os.makedirs(self.recovery_dir, exist_ok=True)

    def _cmp(self, a: float, b: float) -> bool:
        return a < b if self.decreasing else a > b

    def _payload(self, make_payload: Callable[[], Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """`make_payload()` on the rank that writes, and on the ranks of its
        model group, whose shards the payload gathers; None elsewhere."""
        if self.enabled or (mesh.model_count() > 1 and mesh.data_index() == 0):
            return make_payload()
        return None

    def save_checkpoint(self, make_payload: Callable[[], Dict[str, Any]], epoch: int,
                        metric: Optional[float] = None, prefix: str = ""
                        ) -> Tuple[Optional[float], Optional[int]]:
        """Write last + ranked snapshot of `make_payload()`; returns
        (best_metric, best_epoch). `prefix` names a separate series (the
        supernet search's "-search"). A disabled saver calls nothing and
        writes nothing."""
        payload = self._payload(make_payload)
        if self.enabled:
            self._write(payload, epoch, metric, prefix)
        if metric is not None and (self.best_metric is None
                                   or self._cmp(metric, self.best_metric)):
            self.best_metric, self.best_epoch = metric, epoch
            if self.enabled:
                last = os.path.join(self.checkpoint_dir, f"last{prefix}{CKPT_EXT}")
                self._link(last, os.path.join(self.checkpoint_dir, f"model_best{CKPT_EXT}"))
        mesh.barrier("checkpoint")
        return self.best_metric, self.best_epoch

    def _write(self, payload: Dict[str, Any], epoch: int, metric: Optional[float],
               prefix: str) -> None:
        payload = dict(payload, epoch=epoch, metric=metric, version=2)
        last = os.path.join(self.checkpoint_dir, f"last{prefix}{CKPT_EXT}")
        save_checkpoint_file(last, payload)
        if epoch % NO_DEL_INTERVAL == 0:
            self._link(last, os.path.join(self.checkpoint_dir,
                                          f"keep-{epoch}{prefix}{CKPT_EXT}"))
        worse_than_all = (len(self.checkpoint_files) >= self.max_history
                          and metric is not None
                          and not self._cmp(metric, self.checkpoint_files[-1][1]))
        if not worse_than_all:
            snap = os.path.join(self.checkpoint_dir,
                                f"checkpoint-{epoch}{prefix}{CKPT_EXT}")
            self._link(last, snap)
            self.checkpoint_files.append((snap, metric if metric is not None
                                          else float("-inf")))
            self.checkpoint_files.sort(key=lambda t: t[1], reverse=not self.decreasing)
            while len(self.checkpoint_files) > self.max_history:
                path, _ = self.checkpoint_files.pop()
                try:
                    os.remove(path)
                except OSError:
                    pass

    def save_recovery(self, make_payload: Callable[[], Dict[str, Any]], epoch: int,
                      batch_idx: int) -> None:
        payload = self._payload(make_payload)
        if self.enabled:
            self._write_recovery(payload, epoch, batch_idx)
        mesh.barrier("recovery")

    def _write_recovery(self, payload: Dict[str, Any], epoch: int, batch_idx: int) -> None:
        path = os.path.join(self.recovery_dir, f"recovery-{epoch}-{batch_idx}{CKPT_EXT}")
        save_checkpoint_file(path, dict(payload, epoch=epoch, batch_idx=batch_idx,
                                        version=2))
        for old in glob.glob(os.path.join(self.recovery_dir, f"recovery-*{CKPT_EXT}")):
            if old != path:
                try:
                    os.remove(old)
                except OSError:
                    pass

    def find_recovery(self) -> Optional[str]:
        files = sorted(glob.glob(os.path.join(self.recovery_dir, f"recovery-*{CKPT_EXT}")))
        return files[-1] if files else None

    @staticmethod
    def _link(src: str, dst: str) -> None:
        try:
            if os.path.exists(dst):
                os.remove(dst)
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)


def build_payload(*, state, args_text: str, arch_name: str,
                  stage_info: Dict[str, Any]) -> Dict[str, Any]:
    """The payload of `state`, full tensors under tensor parallelism (a
    collective over the model group)."""
    p: Dict[str, Any] = {
        "arch": arch_name,
        "stage_info": dict(stage_info),
        "state_dict": _cpu(tp.gather_local(state.params)),
        "batch_stats": _cpu(state.batch_stats),
        "optimizer": tp.gather_optimizer_state(state.model, state.optimizer),
        "step": state.step,
        "args_text": args_text,
    }
    for i, ema in enumerate(state.ema_params):
        p[f"state_dict_ema_{i}"] = _cpu(tp.gather_local(ema))
    return p


def _same_keys(what: str, got: Mapping[str, Any], want: Mapping[str, Any]) -> None:
    if set(got) != set(want):
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        raise KeyError(f"{what} does not fit the model: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")


#: the state each kind of optimizer keeps per parameter, by name
_OPT_STATE = {"adam": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buffer",)}


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: Mapping[str, Any],
                    names: Dict[int, str]) -> None:
    """The port's own optimizer `state_dict` (keyed by index: the optimizer
    must be made by `create_optimizer` for the same arch), or the state by
    name that `convert.optax_to_torch_state` makes of a JAX file (Adam
    moments or the SGD momentum; cast to the optimizer's own dtypes: a bf16
    `exp_avg` under --adam-mu-bf16). Either way the hyperparameters stay the
    current run's."""
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    kind = "sgd" if isinstance(optimizer, NesterovSGD) else "adam"
    if "state" in saved and "param_groups" in saved:
        optimizer.load_state_dict(saved)
    elif any(k in saved for ks in _OPT_STATE.values() for k in ks):
        if not all(k in saved for k in _OPT_STATE[kind]):
            raise NotImplementedError(
                f"the checkpoint's optimizer state ({sorted(saved)}) is not the state of "
                f"this run's optimizer ({type(optimizer).__name__}); use --no-resume-opt")
        for k in _OPT_STATE[kind]:
            _same_keys("the optimizer state", saved[k], names.values())
        mu_dtype = torch.bfloat16 if isinstance(optimizer, AdamWBf16Mu) else None
        for group in optimizer.param_groups:
            for p in group["params"]:
                n = names[id(p)]
                st = {k: saved[k][n].to(p.device, p.dtype).clone() for k in _OPT_STATE[kind]}
                if kind == "adam":
                    st["step"] = torch.tensor(float(saved["count"]), dtype=torch.float32)
                    st["exp_avg"] = st["exp_avg"].to(mu_dtype or p.dtype)
                optimizer.state[p] = st
    else:
        raise NotImplementedError("the checkpoint's optimizer state is neither the port's "
                                  "nor an optax Adam or trace state; use --no-resume-opt")
    for g, h in zip(optimizer.param_groups, hyper):
        g.update(h)


def restore_state(ckpt: Mapping[str, Any], state, *, restore_opt: bool = True):
    """Install a payload in `state` (in place; returned for convenience):
    parameters, BatchNorm stats, the optimizer (unless `restore_opt` is
    False, `--no-resume-opt`), every EMA tree (a tree the file lacks starts
    as a copy of the parameters) and the step. Stored values are cast to the
    template's dtypes. The names must match: build the checkpoint's arch
    first."""
    model = state.model
    params = dict(model.named_parameters())
    _same_keys("state_dict", ckpt["state_dict"], params)
    buffers = dict(model.named_buffers())
    stats = ckpt.get("batch_stats") or {}
    if buffers or stats:
        _same_keys("batch_stats", stats, buffers)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(ckpt["state_dict"][n])
        for n, b in buffers.items():
            b.copy_(stats[n])
        for i, tree in enumerate(state.ema_params):
            src = ckpt.get(f"state_dict_ema_{i}", ckpt["state_dict"])
            _same_keys(f"state_dict_ema_{i}", src, tree)
            for n, t in tree.items():
                t.copy_(src[n])
    if restore_opt and ckpt.get("optimizer"):
        _load_optimizer(state.optimizer, ckpt["optimizer"],
                        {id(p): n for n, p in params.items()})
    state.step = int(ckpt.get("step", 0))
    return state
