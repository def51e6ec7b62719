"""Device ms per traced iteration in the convolutions' kernels: the
trace's rows whose name matches ``conv.KERNELS``, the pattern
``(?i)conv|cudnn|fprop|dgrad|wgrad|winograd|fft`` (cuDNN's forward,
data- and weight-gradient kernels of every ``Conv1d`` and
``ConvTranspose1d``, and its layout helpers; not cuBLAS's GEMMs of the
dense layers). Nothing to read where no convolution ran."""

from benchmark.conv import KERNELS
from benchmark.trace import device_seconds


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["traced"]["iterations"]:
        return None
    s = device_seconds(t, KERNELS)
    if s <= 0:
        return None
    return 1e3 * s / run["traced"]["iterations"]
