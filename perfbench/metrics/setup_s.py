"""setup_s: seconds from the process's start to the window's (imports, the
kernel build or load, the weights, the set-up steps)."""


def read(run):
    return run.setup_s
