"""Repo-wide pytest hook: build the C++ host runtime once, before any worker.

`ggs_tpu.native` builds `libggs_native.so` with `make` at first use, and
the Makefile writes the library in place. Under pytest-xdist every worker
that imports `tests/test_native.py` would start that build, and a worker
that loads a half-written library marks the build failed, so the module's
`skipif` skips all of its tests. Building it here, once, in the controller
process (the one without `workerinput`) before the workers start leaves
them a finished library to load. This file imports neither JAX nor torch:
`ggs_tpu.native` needs only numpy and ctypes.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from ggs_tpu import native

    native.available()
