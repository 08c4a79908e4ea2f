"""step_mfu.decode: the model operations of every call in the profiled
slice (decode steps and admissions' prefills) over the slice's seconds at
the H100's bf16 peak, in %."""

from portbench import readers as R


def read(run):
    return R.mfu(run)
