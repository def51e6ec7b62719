"""Host ms per traced iteration in the models' and autograd's glue
(``glue.*``: the stacks' and layers' forward and backward outside their
kernels' launches), the program's own record (``rsrgan_tpu_torch.spans``):
self time summed over the threads (the autograd engine's too), read at
the untraced pace (times the untraced window's time for the same
iterations over the traced window's: the profiler slows the host)."""

PREFIX = "glue."


def read(run):
    t, traced = run.get("trace"), run.get("traced")
    if run["kind"] != "train" or not t or not traced["iterations"]:
        return None
    try:
        from rsrgan_tpu_torch import spans
    except ImportError:   # a program without spans
        return None
    r = spans.read()
    own = [ns for name, ns in r.self_ns().items() if name.startswith(PREFIX)]
    if not own or r.dropped:
        return None
    return (sum(own) / 1e6 / traced["iterations"]
            * traced["paced_s"] / t["window_s"])
