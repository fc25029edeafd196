"""backbone_device_ms.rollout: device ms a rollout step in the port's ``fluid.backbone`` span.

Layer: backbone (the post-LN OPT blocks, ``project_in``/``project_out``, the
last block from the newest frame (``self.backbone(...)``)). The device
events of the traced rollout launched inside the span (``lib/spans.py``),
summed, over its steps. Moves ``rollout_frames_per_s``.
"""

from portbench.lib import spans

LAYER = "backbone"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
