"""FLUID-LLM in PyTorch with hand-written CUDA kernels for Hopper.

The second package of this repository, beside ``fluid_llm_tpu`` (JAX on a
TPU), which stays the reference it is held against.  Module names follow
the JAX package so each counterpart is easy to find.  So far the port holds
the serving slice: synthetic cylinder data, the OPT/GPT-2 backbone with
merged DoRA adapters, the MLPGNN decoder and the 251-step exact rollout of
``inference.py``.

- ``core``     mesh->grid resampling (host numpy geometry, torch gather).
- ``data``     windows, patches and position ids; the synthetic dataset.
- ``ops``      patch algebra, the grid GATv2, and the CUDA kernels
               (``csrc/``) with their plain PyTorch twins.
- ``models``   backbone, embeddings, decoders, LoRA/DoRA, ``FluidLLM``.
- ``rollout``  the autoregressive window rollout.
- ``train``    the N-RMSE metric.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
