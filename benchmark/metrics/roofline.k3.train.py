"""K3 (the G walk on K2's grid in acc mode, the D layer's row-group
walk, and their reduction ``lstm_wgrad_kernel``): the least time of its
launches in the traced window (``roofline.bwd_bound`` with acc, whose
count holds the reduction's products too) over their device time, %.
Nothing to read where K3 did not run."""

from benchmark.roofline import bwd_bound, parse_key, row_lengths
from benchmark.trace import device_seconds

KERNELS = (r"lstm_bwd_resident_kernel<[^>]*\btrue>|lstm_bwd_rowgroup_kernel"
           r"|lstm_wgrad_kernel|\blstm_bwd_kernel\b")


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t:
        return None
    device_s = device_seconds(t, KERNELS)
    bound_ms = 0.0
    for it in run["traced"]["per_iter"]:
        for key, n in it["launches"]["k3"].items():
            s = parse_key(key)
            lens = row_lengths(s["B"], it["lengths"])
            if lens is None:
                return None
            bound_ms += n * bwd_bound(s["U"], s["P"], s["B"], it["t_pad"],
                                      lens, run["dtype_name"],
                                      acc=True)["bound_ms"]
    if device_s <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / device_s
