"""CUDA launch calls (the profiler's runtime rows ``cudaLaunch*`` and
``cuLaunch*``) in the traced window, per iteration."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["traced"]["iterations"]:
        return None
    return t["launches"] / run["traced"]["iterations"]
