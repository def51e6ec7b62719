"""K4 in decode mode (``wavefront_resident_kernel``, ``save_acts=False``):
the least time of its launches in the traced window
(``roofline.wavefront_bound(train=False)`` from each decode batch's
shape and true lengths; one launch a batch) over its device time, %."""

from benchmark.roofline import wavefront_bound
from benchmark.trace import device_seconds

KERNEL = r"\bwavefront_resident_kernel\b"


def read(run):
    t = run.get("trace")
    if run["kind"] != "decode" or not t or not run["traced"]["calls"]:
        return None
    g = run["generator"]
    bound_ms = sum(wavefront_bound(
        g["num_layers"], g["cell_size"], g["num_proj"], len(c["lengths"]),
        c["t_pad"], c["lengths"], run["dtype_name"], train=False,
        residual=g["residual"] == "layer")["bound_ms"]
        for c in run["traced"]["calls"])
    device_s = device_seconds(t, KERNEL)
    if device_s <= 0 or run["traced"]["k4_launches"] != len(
            run["traced"]["calls"]):
        return None
    return 100.0 * bound_ms / 1e3 / device_s
