"""The port's data-layer counter: ``make_batches.stats``.

``fluid_llm_tpu_torch/data/pipeline.make_batches`` counts, over the
process, the samples it built and the seconds spent building them, summed
over the threads that built them.  This is the one module of the harness,
besides ``lib/port.py`` and the drivers, that reads the port for a
per-layer metric.  A program without the counter reads None.
"""

from __future__ import annotations

from fluid_llm_tpu_torch.data import pipeline


def sample_build_ms():
    """Host ms to build one sample, on the thread that built it; None
    where the program has no counter or built nothing."""
    st = getattr(pipeline.make_batches, "stats", None)
    if not st or not st.get("samples"):
        return None
    return 1e3 * st["build_s"] / st["samples"]
