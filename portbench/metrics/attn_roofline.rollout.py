"""attn_roofline.rollout: the rollout's window attention against its roofline.

Layer: kernels (``ops/exact_attention.py`` -> ``csrc/exact_attention.cu``).
The least time of the full-window attention of every block but the last,
at each step's valid tokens (bytes and operations from (B, L, H, 64),
``lib/readers``), over the device time of the kernel below in the traced
rollout.  Moves ``rollout_frames_per_s``.
"""

from portbench.lib import readers

LAYER = "kernels"
MOVES = "rollout_frames_per_s"
SOURCE = "device_trace"
KERNELS = ("exact_attention_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.run.traced_steps:
        return None
    rollouts = ctx.run.traced_steps // ctx.run.steps
    return readers.share(readers.attn_rollout_bound(ctx.run, rollouts),
                         ctx.trace.kernel_seconds(KERNELS))
