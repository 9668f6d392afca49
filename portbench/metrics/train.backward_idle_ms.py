"""train.backward_idle_ms: device-idle milliseconds a step while the host is
in ``msid.train.backward`` (``loss.backward()``), the steps counted by
their ``msid.train.update`` spans. Moves ``train_tiles_per_s``."""

from portbench.spans import idle_under, per_step_ms


def read(trace):
    return per_step_ms(idle_under(trace, ("msid.train.backward",)), trace)
