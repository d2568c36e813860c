"""device_idle.insert: the share of the traced window in which no
operation ran on the device, in percent."""

from spcbench.devtrace import idle_percent


def read(run):
    return idle_percent(run.trace)
