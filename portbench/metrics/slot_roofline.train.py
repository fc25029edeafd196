"""slot_roofline.train: the MLPGNN decoder's slot attention against its roofline.

Layer: kernels (``ops/grid_gnn_fused.py`` -> ``csrc/grid_slot_attention.cu``).
The least time of the five-slot grid attention of every conv over every
frame of the traced steps, forward and backward (bytes and operations from
(frames, 240, 64, C), ``lib/readers``), over the device time of the
kernels below.  Moves ``train_samples_per_s``.
"""

from portbench.lib import readers

LAYER = "kernels"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = ("grid_slot_fwd_kernel", "grid_slot_bwd_kernel", "grid_slot_bwd_datt_kernel")


def read(ctx):
    run = ctx.run
    if ctx.trace is None or not run.traced_steps:
        return None
    frames = run.traced_steps * run.batch_size * run.frames
    return readers.share(readers.slot_bound(run, frames, backward=True),
                         ctx.trace.kernel_seconds(KERNELS))
