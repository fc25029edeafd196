"""sample_build_ms.rollout: host ms to build one sample in the port's data layer.

Layer: data (``data/pipeline.py`` ``make_batches``: ``PatchDataset.sample``
and the stack of a batch, on the thread that builds it). The counter
``make_batches.stats`` over the batches set-up built: seconds summed over
the building threads, over the samples. Against ``batch_build_ms.rollout``
(the wall clock a batch) it gives the workers busy at once. Moves
``setup_s``.
"""

from portbench.lib import data_stats

LAYER = "data"
MOVES = "setup_s"
SOURCE = "program_counter"


def read(ctx):
    return data_stats.sample_build_ms()
