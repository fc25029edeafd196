"""window_device_ms.rollout: device ms a rollout step of the rollout loop's own ops.

Layer: loops (``rollout/generate.py`` ``_generate``). The device events of
the traced rollout launched in ``fluid.rollout_step`` or ``fluid.rollout``
but in none of the model's spans: the sliding window's glue (slot masks,
positions, the duplicated first frame, ``img_to_patch``, the boundary
``where``, the window's ``cat``), summed, over the steps (``lib/spans.py``).
Moves ``rollout_frames_per_s``.
"""

from portbench.lib import spans

LAYER = "loops"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, "window")
