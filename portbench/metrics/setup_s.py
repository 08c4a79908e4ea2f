"""setup_s: process start to the window's first step: imports, the
weights drawn on the card, the plan's packing, the engine, the kernels'
build where it has not run yet, and the warm-up to a steady load."""


def read(run):
    return run.setup_s
