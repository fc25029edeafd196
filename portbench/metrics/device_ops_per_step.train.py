"""device_ops_per_step.train: device operations a training step.

Layer: loops (``train/trainer.py`` ``Trainer.train_step``).  Kernels, memory copies and memory sets in the traced
sub-window, over the steps traced: a count, so it repeats exactly; it is
what the host's dispatch pays for.  Moves ``train_samples_per_s``.
"""

LAYER = "loops"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not ctx.run.traced_steps or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.run.traced_steps
