"""setup_s: seconds from the start of the run to the start of the window
(imports, CUDA, the kernels built or loaded, the job pool, one warm-up
job)."""


def read(rec):
    return rec["setup_s"]
