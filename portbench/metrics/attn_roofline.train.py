"""attn_roofline.train: the training step's attention against its roofline.

Layer: kernels (``ops/flash_attention.py`` -> ``csrc/exact_attention.cu``
for the forward, ``csrc/flash_attention.cu`` for dq and dk/dv).  The least
time of the attention of every block of the traced steps (forward and
backward, bytes and operations from (B, L, H, 64), ``lib/readers``) over
the device time of the kernels below.  Moves ``train_samples_per_s``.
"""

from portbench.lib import readers

LAYER = "kernels"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
KERNELS = ("exact_attention_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.run.traced_steps:
        return None
    return readers.share(readers.attn_train_bound(ctx.run, ctx.run.traced_steps),
                         ctx.trace.kernel_seconds(KERNELS))
