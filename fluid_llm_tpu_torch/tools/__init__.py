"""Deployment tools: the serving daemon and its bench (``fluid_llm_tpu/tools``)."""
