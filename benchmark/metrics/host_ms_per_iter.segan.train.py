"""Host ms per traced iteration in SEGAN's nets outside their library
calls (``segan.*``: the auto-encoder's encoder and decoder, D's forward
and its virtual batch norms), the program's own record
(``rsrgan_tpu_torch.spans``): self time summed over the threads, read
at the untraced pace (times the untraced window's time for the same
iterations over the traced window's: the profiler slows the host)."""

PREFIX = "segan."


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
