"""decoder_device_ms.rollout: device ms a rollout step in the port's ``fluid.decoder`` span.

Layer: decoder (the MLPGNN decoder of the newest frame and its diff image
(``decode_frame_tokens``)). The device events of the traced rollout launched
inside the span (``lib/spans.py``), summed, over its steps. Moves
``rollout_frames_per_s``.
"""

from portbench.lib import spans

LAYER = "decoder"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
