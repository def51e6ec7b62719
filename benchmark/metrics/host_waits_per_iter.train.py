"""Blocking copies per traced iteration: the program's ``host_wait``
counter (``rsrgan_tpu_torch.spans``), one for each copy from pageable
memory to the card or read back that the hot path makes, each of which
waits for the card's queue to drain. A count: no pace to correct."""


def read(run):
    traced = run.get("traced")
    if run["kind"] != "train" or not run.get("trace") or \
            not traced["iterations"]:
        return None
    try:
        from rsrgan_tpu_torch import spans
    except ImportError:   # a program without spans
        return None
    r = spans.read()
    if not r.spans or r.dropped:
        return None
    return r.total("host_wait") / traced["iterations"]
