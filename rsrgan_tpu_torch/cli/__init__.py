"""Command-line entry points of the port: ``train`` (training and
``--decode``) and ``prepare`` (data preparation)."""


def str2bool(v) -> bool:
    """Boolean flag parser: only yes/true/t/1 (case-insensitive) are
    truthy, as in the JAX package's CLIs."""
    return str(v).lower() in ("yes", "true", "t", "1")
