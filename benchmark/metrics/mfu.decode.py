"""The decode's model FLOPs (G's products at true frames) in the
untraced window over its length and the card's bf16 peak, %."""

from benchmark.roofline import PEAK_FLOPS


def read(run):
    if run["kind"] != "decode" or not run["passes"]:
        return None
    return 100.0 * run["flops_per_frame"] * run["frames"] / (
        run["window_s"] * PEAK_FLOPS["bfloat16"])
