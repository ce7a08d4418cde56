"""setup_s (end to end, host clock): from the start of the process's
harness to the end of set-up: importing torch and the program, loading the
kernel libraries (building them with nvcc where the checkout has none yet),
making the cell's forcing from the seed and the warm calls."""


def read(run):
    return run.setup_s
