"""True frames decoded in the window (whole passes over the test set,
denormalised and on the host), over the window's wall time."""


def read(run):
    if run["kind"] != "decode" or not run["passes"]:
        return None
    return run["frames"] / run["window_s"]
