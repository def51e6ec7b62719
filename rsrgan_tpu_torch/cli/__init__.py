"""Command-line entry points of the port: ``train`` (training and
``--decode``), ``prepare`` (data preparation), ``simulate`` (corpus
corruption), ``extract`` (features on the card), ``resynth``, ``score``
and ``plot``."""


def str2bool(v) -> bool:
    """Boolean flag parser: only yes/true/t/1 (case-insensitive) are
    truthy, as in the JAX package's CLIs."""
    return str(v).lower() in ("yes", "true", "t", "1")


def resolve_device(name: str):
    """The run's ``torch.device``. A CUDA device that is not there is an
    error: a CLI never carries on on the CPU unless asked to."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device={name} but no CUDA device is available (pass "
            "--device=cpu to run the plain PyTorch path on the CPU)")
    return device


def set_precision() -> None:
    """f32 means f32 on a card: no TF32 in matmuls or in cuDNN's
    convolutions (the frame models'), where PyTorch's default for the
    latter is TF32. Every CLI that computes on the card calls it first:
    a caller in the same process may have turned TF32 on."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
