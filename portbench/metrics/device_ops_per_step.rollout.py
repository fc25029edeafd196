"""device_ops_per_step.rollout: device operations a rollout step (one predicted frame of the batch).

Layer: loops (``rollout/generate.py`` ``_generate``).  Kernels, memory copies and memory sets in the traced
sub-window, over the steps traced: a count, so it repeats exactly; it is
what the host's dispatch pays for.  Moves ``rollout_frames_per_s``.
"""

LAYER = "loops"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not ctx.run.traced_steps or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.run.traced_steps
