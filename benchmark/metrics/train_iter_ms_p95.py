"""The 95th percentile (numpy's linear interpolation) of every window
iteration's time, from CUDA events recorded on the stream at each
iteration's end: device time between two ends, any wait for the host
included."""

import numpy as np


def read(run):
    if run["kind"] != "train" or not run["iter_ms"]:
        return None
    return float(np.percentile(run["iter_ms"], 95))
