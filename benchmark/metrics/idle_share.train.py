"""Share of the time in which no kernel, copy or set ran on the card
(training cells), %: the device time of the traced iterations (the union
of the trace's rows) over the time the untraced window took for the same
iterations (from its CUDA events). The profiler slows the host, so the
traced window's own length would overstate the idle share."""


def read(run):
    t, traced = run.get("trace"), run.get("traced")
    if run["kind"] != "train" or not t or not traced["paced_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / traced["paced_s"])
