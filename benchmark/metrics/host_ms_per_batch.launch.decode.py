"""Host ms per traced decode batch on the kernels' host side
(``launch.*``: K4's plan, weight packing, uploads and call), the
program's own record (``rsrgan_tpu_torch.spans``): self time per
``decode.batch``, read at the untraced pace (times the untraced window's
time for the same passes over the traced window's: the profiler slows
the host)."""

PREFIX = "launch."


def read(run):
    t, traced = run.get("trace"), run.get("traced")
    if run["kind"] != "decode" or not t or not traced["passes"]:
        return None
    try:
        from rsrgan_tpu_torch import spans
    except ImportError:   # a program without spans
        return None
    r = spans.read()
    batches = r.units("decode.batch")
    own = [ns for name, ns in r.self_ns().items() if name.startswith(PREFIX)]
    if not batches or not own or r.dropped:
        return None
    return sum(own) / 1e6 / batches * traced["paced_s"] / t["window_s"]
