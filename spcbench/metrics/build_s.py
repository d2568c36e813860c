"""build_s: the host clock around ``SPCService(...)`` in set-up (the
index build), synchronised with the device."""


def read(run):
    return run.build_s
