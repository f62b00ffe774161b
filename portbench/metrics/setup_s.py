"""Seconds from the start of the harness's process to the first timed
block: imports, the kernel libraries from the build cache, target, mask,
the program's first state and evaluation, the warm-up blocks and their
capture."""


def read(rec):
    return rec.setup_s
