"""setup_s: seconds from the process's start to the first timed request
(imports, the CUDA context, inputs and weights from the seed, the task,
the kernels' build where it is not cached, warm-up and captures)."""


def read(r):
    return r.setup_s
