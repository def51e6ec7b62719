"""Device ms per iteration in rows that are not the program's own
kernels (``csrc/*.cu``): cuBLAS, copies, sets, elementwise and
reductions."""

from benchmark.trace import is_hand_kernel


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["traced"]["iterations"]:
        return None
    s = sum(v for name, v in t["device_s_by_name"].items()
            if not is_hand_kernel(name))
    return 1e3 * s / run["traced"]["iterations"]
