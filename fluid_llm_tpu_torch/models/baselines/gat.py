"""GAT baseline: the MeshGraphNet scaffold with chained multi-head GAT layers.

Counterpart of ``fluid_llm_tpu/models/baselines/gat.py``
(``eagle/Models/GraphAttention.py:13-110``): the same encoders, decoder,
normalizers and rollout as :class:`~.mgn.MGN`, but the processor is
residual :class:`~.base.MultiHeadGAT` layers (softmax-free segment-sum
attention, ``eagle/Models/Base.py:52-86``) and the edges are not updated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fluid_llm_tpu_torch.models.baselines.base import MultiHeadGAT
from fluid_llm_tpu_torch.models.baselines.mgn import MGN


class GAT(MGN):
    """``gat_init`` / ``gat_apply``: ``processor.<i>.heads.<h>`` hold each
    head's bias-free ``f_edge`` and its ``att``; :meth:`MGN.apply` is the
    rollout."""

    def __init__(self, state_size: int = 4, n_processor: int = 8, n_heads: int = 4,
                 generator: Optional[torch.Generator] = None):
        self.n_heads = n_heads
        super().__init__(state_size, n_processor, generator)

    def _processor(self, n_processor: int, generator) -> nn.ModuleList:
        return nn.ModuleList(MultiHeadGAT(128, 128, self.n_heads, generator)
                             for _ in range(n_processor))

    def process(self, V, E, senders, receivers) -> torch.Tensor:
        for layer in self.processor:
            V = V + layer(V, E, senders, receivers, self.kernels)
        return V
