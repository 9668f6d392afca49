"""train.loader_ms: host milliseconds a step inside ``msid.data.batch`` (the
device tile cache's index upload and gather), the steps counted by their
``msid.train.update`` spans: ``train.data_wait_ms`` measured where the work
happens. Moves ``train_tiles_per_s``."""

from portbench.spans import per_step_ms, span_seconds


def read(trace):
    return per_step_ms(span_seconds(trace, ("msid.data.batch",)), trace)
