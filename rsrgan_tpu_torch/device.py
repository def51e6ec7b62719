"""The run's device and its f32 precision, shared by the CLIs and the
library classes that put tensors on a device (``serving``, the proxy).
It imports ``torch`` only when called: ``cli.prepare`` needs numpy
alone."""


def resolve_device(name: str):
    """The run's ``torch.device``. A CUDA device that is not there is an
    error: nothing carries on on the CPU unless asked to."""
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
