"""decoder_device_ms.train: device ms a training step in the port's ``fluid.decoder`` span.

Layer: decoder (the MLPGNN decoder and the diff image's permute, cast and
scale (``self.decoder(...)``)). The device events of the traced steps
launched inside the span, and the backward's that its forward ops' autograd
nodes launch (``lib/spans.py``), summed, over the steps traced. Moves
``train_samples_per_s``.
"""

from portbench.lib import spans

LAYER = "decoder"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return spans.device_ms(ctx, LAYER)
