"""Models of the port; importing registers the builders."""

from autoprog_tpu_torch.models import factory  # noqa: F401
