"""optimizer_device_ms.train: device ms a training step in the port's ``fluid.optimizer`` span.

Layer: optimizer (``zero_grad`` and AdamW's ``step``). The device events of
the traced steps launched inside the span, and the backward's that its
forward ops' autograd nodes launch (``lib/spans.py``), summed, over the
steps traced. Moves ``train_samples_per_s``.
"""

from portbench.lib import spans

LAYER = "optimizer"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
