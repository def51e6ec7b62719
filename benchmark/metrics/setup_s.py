"""Set-up: the process's start to the window's (imports, the card, the
program's kernels, weights and inputs, the checked iterations and the
warm-up). Seconds, host clock."""


def read(run):
    return run["setup_s"]
