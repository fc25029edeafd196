"""batch_build_ms.rollout: the host's time to build one batch of the cell's traffic.

Layer: data (``data/pipeline.py`` ``make_batches``, ``PatchDataset.sample``,
``core/interp.resample_to_grid``).  The harness's clock around the
batches that set-up builds onto the card through the port's
``make_batches``, over their number.  The window steps on those batches,
so the building is part of set-up.  Moves ``setup_s``.
"""

LAYER = "data"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    b = getattr(ctx.run, "build", None)
    return 1e3 * b["seconds"] / b["batches"] if b and b["batches"] else None
