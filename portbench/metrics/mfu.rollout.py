"""mfu.rollout: the rollout's model operations over the card's bf16 peak.

Layer: model step (``models/fluid_llm.py`` ``predict_frame_diff``,
``models/backbone.py``, ``models/decoders.py``).  The operations each
rollout needs, counted from its shapes by ``lib/counts.rollout_ops`` (the
window's valid tokens through the blocks, the last block from the newest
frame, that frame decoded), times the rollouts of the measured window, over
its wall time times 989 TFLOP/s (H100 SXM, bf16 dense, published).  Moves
``rollout_frames_per_s``.
"""

from portbench.lib import peaks

LAYER = "model step"
MOVES = "rollout_frames_per_s"
SOURCE = "host_clock"


def read(ctx):
    m = ctx.run.measure
    if not m.get("rollouts") or ctx.device.type != "cuda":
        return None
    return 100.0 * m["rollout_ops"] * m["rollouts"] / (m["wall_s"] * peaks.PEAK_OPS_PER_S["bf16"])
