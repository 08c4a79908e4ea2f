"""moe_ms.decode: device time of the kernels launched inside
repro_torch.models.moe.apply_moe during decode steps, a decode step, over
the profiled slice."""

from portbench import readers as R
from portbench import trace as T


def read(run):
    p = R.profile(run)
    if p is None or T.MOE_IN_DECODE not in p.range_device_s or T.DECODE not in p.range_device_s:
        return None
    moe_s = p.range_device_s[T.MOE_IN_DECODE][0]
    steps = p.range_device_s[T.DECODE][1]
    if moe_s <= 0 or not steps:
        return None
    return 1e3 * moe_s / steps
