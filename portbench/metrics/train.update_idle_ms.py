"""train.update_idle_ms: device-idle milliseconds a step while the host is
in ``msid.train.update`` (the global norm, the finite check's host sync,
the clip, AdamW and the EMA), the steps counted by those spans. Moves
``train_tiles_per_s``."""

from portbench.spans import idle_under, per_step_ms


def read(trace):
    return per_step_ms(idle_under(trace, ("msid.train.update",)), trace)
