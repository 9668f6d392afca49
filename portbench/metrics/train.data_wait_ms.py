"""train.data_wait_ms: host milliseconds a step spends in the loader's
``next()`` (the device tile cache's gather), on the benchmark's clock, over
the traced steps. Moves ``train_tiles_per_s``."""


def read(trace):
    return trace.extra.get("data_wait_ms")
