"""setup_s: process start to the start of the window's first job."""


def read(run):
    return run.setup_s
