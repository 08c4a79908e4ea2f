"""kernel_roofline.decode: the least time of the profiled decode steps'
work (portbench/work.py) over the device time of the kernels inside them,
in %."""

from portbench import readers as R


def read(run):
    return R.roofline(run, "decode")
