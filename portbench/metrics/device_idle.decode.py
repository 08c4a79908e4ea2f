"""device_idle.decode: share of the profiled slice with no device
operation running (the union of their intervals), in %."""

from portbench import readers as R


def read(run):
    return R.idle(run)
