"""Device ms per traced iteration in the collectives' kernels on the
traced rank (rank 0): the trace's rows whose name holds ``nccl`` (any
case: NCCL's all-reduce kernels). Nothing to read in a world of one."""

from benchmark.trace import device_seconds

KERNELS = r"(?i)nccl"


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["traced"]["iterations"]:
        return None
    s = device_seconds(t, KERNELS)
    if s <= 0:
        return None
    return 1e3 * s / run["traced"]["iterations"]
