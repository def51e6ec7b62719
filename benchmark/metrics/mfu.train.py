"""The training iterations' model FLOPs (``roofline``: every product of
G and D, forward and backward, at true frames) in the untraced window
over its length and the card's bf16 peak, %."""

from benchmark.roofline import PEAK_FLOPS


def read(run):
    if run["kind"] != "train" or not run["iterations"]:
        return None
    return 100.0 * run["flops_per_frame"] * run["frames"] / (
        run["window_s"] * PEAK_FLOPS["bfloat16"])
