"""Model registry of the port (`autoprog_tpu/registry.py`).

Builders register under a name; `create_model` also understands the
`<family>_h<H>_l<L>` grammar through the `model_variant` builder. The model
modules register on first use, so importing the package stays light.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models() -> List[str]:
    import autoprog_tpu_torch.models  # noqa: F401
    return sorted(_REGISTRY)


def create_model(model_name: str, **kwargs):
    """A `ModelDef` (models/factory.py) for a registered or variant name."""
    import autoprog_tpu_torch.models  # noqa: F401
    from autoprog_tpu_torch.config import is_variant_name

    if model_name in _REGISTRY:
        return _REGISTRY[model_name](**kwargs)
    if is_variant_name(model_name):
        return _REGISTRY["model_variant"](variant=model_name, **kwargs)
    raise KeyError(
        f"Unknown model {model_name!r}. Known: {list_models()} "
        f"or any '<family>_h<H>_l<L>' variant name.")
