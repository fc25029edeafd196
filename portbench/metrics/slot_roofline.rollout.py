"""slot_roofline.rollout: the MLPGNN decoder's slot attention in the rollout.

Layer: kernels (``ops/grid_gnn_fused.py`` -> ``csrc/grid_slot_attention.cu``).
The least time of the five-slot grid attention of every conv over the one
frame a row that each rollout step decodes (bytes and operations from
(B, 240, 64, C), ``lib/readers``), over the device time of the kernel below
in the traced rollout.  Moves ``rollout_frames_per_s``.
"""

from portbench.lib import readers

LAYER = "kernels"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"
KERNELS = ("grid_slot_fwd_kernel",)


def read(ctx):
    run = ctx.run
    if ctx.trace is None or not run.traced_steps:
        return None
    frames = run.traced_steps * run.batch_size
    return readers.share(readers.slot_bound(run, frames, backward=False),
                         ctx.trace.kernel_seconds(KERNELS))
