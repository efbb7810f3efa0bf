"""setup_s: process start to the end of the warm-up problem (imports,
CUDA context, kernels loaded or built, the cell's shapes warmed)."""


def read(run):
    return run.setup_s
