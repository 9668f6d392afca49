"""train.forward_idle_ms: device-idle milliseconds a step while the host is
in ``msid.train.forward`` (the autocast forward and the loss, train-mode
``Norm`` included), the steps counted by their ``msid.train.update``
spans. Moves ``train_tiles_per_s``."""

from portbench.spans import idle_under, per_step_ms


def read(trace):
    return per_step_ms(idle_under(trace, ("msid.train.forward",)), trace)
