"""True (unpadded) frames of every iteration the window completed, over
the window's wall time, which ends in a sync: the CLI's
``train_frames_per_sec`` taken over the window."""


def read(run):
    if run["kind"] != "train" or not run["iterations"]:
        return None
    return run["frames"] / run["window_s"]
