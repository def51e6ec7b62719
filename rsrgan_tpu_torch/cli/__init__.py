"""Command-line entry points of the port: ``train`` (training and
``--decode``), ``serve`` (streaming enhancement of feature stores or
wavs), ``prepare`` (data preparation), ``simulate`` (corpus corruption),
``extract`` (features on the card), ``resynth``, ``score`` and ``plot``."""

# the device helpers, for the CLIs
from rsrgan_tpu_torch.device import resolve_device, set_precision  # noqa: F401


def str2bool(v) -> bool:
    """Boolean flag parser: only yes/true/t/1 (case-insensitive) are
    truthy, as in the JAX package's CLIs."""
    return str(v).lower() in ("yes", "true", "t", "1")
