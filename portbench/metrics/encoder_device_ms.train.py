"""encoder_device_ms.train: device ms a training step in the port's ``fluid.encoder`` span.

Layer: encoder (the patch encoder, positions, input dropout and the cast to
the backbone's dtype (``FluidLLM._embed``), with the duplicated first
frame). The device events of the traced steps launched inside the span, and
the backward's that its forward ops' autograd nodes launch
(``lib/spans.py``), summed, over the steps traced. Moves
``train_samples_per_s``.
"""

from portbench.lib import spans

LAYER = "encoder"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
