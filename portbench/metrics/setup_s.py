"""setup_s (end to end): process start to the first frame of the window."""


def read(run):
    return run.setup_s
