"""Weight bridge from the JAX package's parameter pytree.

``from_jax_params(tree)`` takes the pytree of ``fluid_llm_tpu``'s
``FluidLLM.init`` (numpy leaves; ``"lora"`` and ``"bos"`` included) and
returns this package's ``FluidLLM.state_dict()``.  Path names are kept
(``backbone.layers.3.attn.q.w`` -> ``backbone.layers.3.attn.q.weight``):

- ``w`` -> ``weight``, transposed: JAX linears are ``x @ w`` with ``w`` of
  shape (in, out), ``nn.Linear`` stores (out, in); a stacked tree
  (``backbone.stack_layers``: ``backbone.layers`` a dict whose leaves lead
  with ``n_layers``) keeps that axis (``…layers.attn.qkv.w`` (n, in, out)
  -> ``…layers.attn.qkv.weight`` (n, out, in)), for a stacked port backbone;
- a convolution's ``w`` under a ``cnn`` list (the CNN patch encoder's
  HWIO ``(kh, kw, in, out)``, the CNN decoder's WIO ``(k, in, out)``), and
  any other 4-D ``w`` (DilResNet's HWIO kernels) -> ``weight`` in torch's
  ``(out, in, kh, kw)`` / ``(out, in, k)``;
- ``b`` -> ``bias``; a norm's ``scale`` -> ``weight``;
- a quantized linear's ``w`` is a dict (``ops/quant.py``): its leaves land
  on the module itself (``ops/quant.QuantLinear``, ``NF4Linear``), the
  int8 ``q`` transposed to (out, in), ``scale`` and the nf4 leaves as
  they are (``…attn.q.w.q`` -> ``…attn.q.q``); a stacked tree's keep their
  leading ``n_layers`` axis, for a stacked quantized port backbone;
- a MoE MLP (``mlp.router``, ``mlp.experts.<name>``): the router's ``w``
  (d, E) as any linear's, an expert bank's ``w`` (E, in, out) -> ``weight``
  (E, out, in) (``models/backbone.ExpertBank``), its ``b`` (E, out) ->
  ``bias``; an int8 bank's ``q`` (E, in, out) -> (E, out, in), ``scale``
  (E, out) as it is;
- every other leaf (position tables, ``att``, LoRA ``A``/``B``/``m``,
  ``bos``; GraphViT's GRU ``w_ih``/``w_hh``/``b_ih``/``b_hh`` and attention
  ``in_w``/``in_b``, GATNet's ``lin``, ``lin_edge`` and ``att_*``, which the
  port's modules keep in the JAX layout) keeps its name and layout;
- a ``None`` leaf (an MLP without LayerNorm, ``"ln": None``) has no
  parameter.

The same bridge takes the baselines' ``mgn_init``, ``gat_init``,
``graphvit_init``, ``gatnet_init`` and ``dilresnet_init`` trees
(``models/baselines``); ``from_jax_norm`` takes the normalizer trees of
MeshGraphNet and GAT.

``to_jax_params(state_dict)`` is the inverse for the dense list layout
(no quantized storage): the reference-checkpoint export
(``tools/reference_ckpt.py``) reads the JAX names through it.
"""

from __future__ import annotations

import numpy as np
import torch

QUANT_LEAVES = ("q", "scale", "codes", "absmax_q", "absmax_scale", "absmax_offset")


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
        elif node is not None:
            *prefix, name = path
            t = _tensor(node)
            if prefix and prefix[-1] == "w" and name in QUANT_LEAVES:
                prefix = prefix[:-1]  # the quantized weight's leaves
                if name == "q":
                    t = t.transpose(-1, -2).contiguous()
            elif name == "w" and ("cnn" in prefix or t.dim() == 4):
                # a convolution: (*spatial, in, out) -> (out, in, *spatial)
                n = t.dim()
                name, t = "weight", t.permute(n - 1, n - 2, *range(n - 2)).contiguous()
            elif name == "w":
                name, t = "weight", t.transpose(-1, -2).contiguous()
            elif name == "b":
                name = "bias"
            elif name == "scale":
                name = "weight"
            out[".".join(prefix + [name])] = t

    walk(tree, [])
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16; widening to f32 is exact
        t = t.float()
    return t.numpy().copy()


def _nest(flat: dict[tuple[str, ...], np.ndarray]):
    """Dotted paths -> nested dicts; a dict whose keys are all indices
    becomes the list it was."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def to_jax_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """Torch ``state_dict`` -> the JAX pytree (numpy leaves), the inverse of
    :func:`from_jax_params` for the dense list layout: ``weight`` -> ``w``
    transposed back (a convolution's permuted back to ``(*spatial, in,
    out)``), a 1-D ``weight`` (a norm's) -> ``scale``, a linear's ``bias``
    -> ``b`` (a norm's, or a bias with no weight beside it, keeps its
    name), every other leaf as it is, indexed keys back into lists.  bf16
    tensors come back as f32.  Quantized storage raises: its leaves have
    no dense JAX counterpart here."""
    flat: dict[tuple[str, ...], np.ndarray] = {}
    for key, t in state_dict.items():
        *prefix, name = key.split(".")
        if name in QUANT_LEAVES:
            raise ValueError(f"{key}: quantized storage has no dense JAX leaf")
        arr = _array(t)
        if name == "weight":
            n = arr.ndim
            if n == 1:
                name = "scale"
            elif "cnn" in prefix or n == 4:
                name, arr = "w", np.ascontiguousarray(arr.transpose(*range(2, n), 1, 0))
            else:
                name, arr = "w", np.ascontiguousarray(np.swapaxes(arr, -1, -2))
        elif name == "bias":
            weight = state_dict.get(".".join(prefix + ["weight"]))
            if weight is not None and weight.dim() >= 2:
                name = "b"
        flat[tuple(prefix + [name])] = arr
    return _nest(flat)


def from_jax_norm(tree) -> dict[str, dict[str, torch.Tensor]]:
    """A graph baseline's normalizer tree (``{"nodes": {"acc", "acc_sq",
    "count", "mean", "std"}, ...}``, numpy leaves) -> the same nesting of f32
    tensors (``models.baselines.base.load_norm`` checks it)."""
    return {name: {k: _tensor(v).float() for k, v in state.items()}
            for name, state in tree.items()}
