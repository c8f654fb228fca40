"""setup_s (s): the process's start to the window's start, on the host
clock: imports, the port's engine, keys, inputs, tables, the kernels'
build where the checkout has none yet, and the warm-up requests."""


def read(rec):
    return rec.setup_s
