"""K2 (``lstm_bwd_resident_kernel`` without acc): the least time of its
launches in the traced window (``roofline.bwd_bound``, from each
launch's shape and its rows' true lengths, read from the program's
launch counters by shape, iteration by iteration) over its device time,
%. Nothing to read where K2 did not run."""

from benchmark.roofline import bwd_bound, parse_key, row_lengths
from benchmark.trace import device_seconds

KERNEL = r"lstm_bwd_resident_kernel<[^>]*\bfalse>"


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t:
        return None
    device_s = device_seconds(t, KERNEL)
    bound_ms = 0.0
    for it in run["traced"]["per_iter"]:
        for key, n in it["launches"]["k2"].items():
            s = parse_key(key)
            lens = row_lengths(s["B"], it["lengths"])
            if lens is None:
                return None
            bound_ms += n * bwd_bound(s["U"], s["P"], s["B"], it["t_pad"],
                                      lens, run["dtype_name"],
                                      acc=False)["bound_ms"]
    if device_s <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / device_s
