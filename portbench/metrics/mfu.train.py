"""mfu.train: the training step's model operations over the card's bf16 peak.

Layer: model step (``models/fluid_llm.py``, ``models/backbone.py``,
``models/lora.py``, ``models/decoders.py``).  The operations a step needs,
counted from its shapes by ``lib/counts.train_step_ops`` (forward, input
gradients, the weight gradients of what trains; causal attention halved),
times the steps of the measured window, over its wall time times 989
TFLOP/s (H100 SXM, bf16 dense, published).  Moves ``train_samples_per_s``.
"""

from portbench.lib import peaks

LAYER = "model step"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(ctx):
    m = ctx.run.measure
    if not m.get("steps") or ctx.device.type != "cuda":
        return None
    return 100.0 * m["step_ops"] * m["steps"] / (m["wall_s"] * peaks.PEAK_OPS_PER_S["bf16"])
