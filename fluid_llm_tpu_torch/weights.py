"""Weight bridge from the JAX package's parameter pytree.

``from_jax_params(tree)`` takes the pytree of ``fluid_llm_tpu``'s
``FluidLLM.init`` (numpy leaves; ``"lora"`` and ``"bos"`` included) and
returns this package's ``FluidLLM.state_dict()``.  Path names are kept
(``backbone.layers.3.attn.q.w`` -> ``backbone.layers.3.attn.q.weight``):

- ``w`` -> ``weight``, transposed: JAX linears are ``x @ w`` with ``w`` of
  shape (in, out), ``nn.Linear`` stores (out, in);
- ``b`` -> ``bias``; a norm's ``scale`` -> ``weight``;
- every other leaf (position tables, ``att``, LoRA ``A``/``B``/``m``,
  ``bos``) keeps its name and layout.

Loading the reference's ``.pt`` checkpoints (``tools/reference_ckpt.py``)
comes later.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy->torch path
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """JAX ``FluidLLM`` params pytree (numpy leaves) -> torch state_dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path: list[str]) -> None:
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + [str(key)])
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, path + [str(i)])
        else:
            *prefix, name = path
            t = _tensor(node)
            if name == "w":
                name, t = "weight", t.T.contiguous()
            elif name == "b":
                name = "bias"
            elif name == "scale":
                name = "weight"
            out[".".join(prefix + [name])] = t

    walk(tree, [])
    return out
