"""encoder_device_ms.rollout: device ms a rollout step in the port's ``fluid.encoder`` span.

Layer: encoder (the patch encoder, positions and the cast to the backbone's
dtype (``FluidLLM._embed``)). The device events of the traced rollout
launched inside the span (``lib/spans.py``), summed, over its steps. Moves
``rollout_frames_per_s``.
"""

from portbench.lib import spans

LAYER = "encoder"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
