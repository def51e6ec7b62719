"""The convolutions (cuDNN, ``conv.KERNELS``): the least time of the
traced iterations' convolutions (``conv.conv_bound_ms``: each counted
forward and the gradients its backward computes, from the program's
counts by shape, ``ops.modules.conv_calls``, iteration by iteration) over
their device time, %. Nothing to read where the run kept no counts."""

from benchmark.conv import KERNELS, conv_bound_ms
from benchmark.trace import device_seconds


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["traced"]["per_iter"]:
        return None
    bound_ms = 0.0
    for it in run["traced"]["per_iter"]:
        if not it.get("convs"):
            return None
        bound_ms += sum(n * conv_bound_ms(key)
                        for key, n in it["convs"].items())
    device_s = device_seconds(t, KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / device_s
