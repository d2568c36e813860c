"""setup_s: process start to the first timed request (graph, index
build, kernel load, warm-up), on the host clock."""


def read(run):
    return run.setup_s
