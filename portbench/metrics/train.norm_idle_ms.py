"""train.norm_idle_ms: device-idle milliseconds a step while the host is in
``msid.norm.train`` (a batch ``Norm``'s train-mode moments, running
statistics and scale), a part of ``train.forward_idle_ms``; the steps
counted by their ``msid.train.update`` spans. Moves ``train_tiles_per_s``."""

from portbench.spans import idle_under, per_step_ms


def read(trace):
    return per_step_ms(idle_under(trace, ("msid.norm.train",)), trace)
