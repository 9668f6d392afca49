"""train.graph_share: the share of train steps that replayed the step's
CUDA graphs (``StepGraphs`` in ``training/train_state.py``), as 100 x the
``msid.train.replay`` spans over the ``msid.train.update`` spans (one of
each a replayed step). 100 when every traced step replays; 0 on a program
whose steps all run eagerly (one without the span); None without update
spans. Moves ``train_tiles_per_s``."""

from portbench.spans import count


def read(trace):
    updates = count(trace, "msid.train.update")
    if not updates:
        return None
    return 100.0 * count(trace, "msid.train.replay") / updates
