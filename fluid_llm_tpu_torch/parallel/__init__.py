"""The parallel axes: the rank mesh, its collectives, pipeline stages and
ring attention (counterpart of ``fluid_llm_tpu/parallel``)."""
