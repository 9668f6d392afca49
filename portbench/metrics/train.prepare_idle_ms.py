"""train.prepare_idle_ms: device-idle milliseconds a step while the host is
in ``msid.train.prepare`` (the step's input made on the device: upload,
preprocessing, band permutation, K2's corruption), the steps counted by
their ``msid.train.update`` spans. Moves ``train_tiles_per_s``."""

from portbench.spans import idle_under, per_step_ms


def read(trace):
    return per_step_ms(idle_under(trace, ("msid.train.prepare",)), trace)
