"""device_idle.rollout: the share of the traced window in which the card ran nothing.

Layer: device (H100).  1 - (the union of the device events' intervals) /
(the traced sub-window's wall time), from the trace's own timeline.  Moves
``rollout_frames_per_s``.
"""

LAYER = "device"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
