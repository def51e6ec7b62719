"""Host ms per traced decode batch in its assembly and denormalisation
(``decode.assemble``, ``decode.denormalize``: the splice-and-fill of the
padded batch and the rows back in the target's units), the program's own
record (``rsrgan_tpu_torch.spans``): self time per ``decode.batch``, read
at the untraced pace (times the untraced window's time for the same
passes over the traced window's: the profiler slows the host)."""

NAMES = ("decode.assemble", "decode.denormalize")


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
    own = [ns for name, ns in r.self_ns().items() if name in NAMES]
    if not batches or not own or r.dropped:
        return None
    return sum(own) / 1e6 / batches * traced["paced_s"] / t["window_s"]
