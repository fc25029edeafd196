"""FLUID-LLM in plain PyTorch: the reference the port is compared with.

Written from the published model (FLUID-LLM, arXiv 2406.04501, its
``src/models/model.py`` and layers; OPT as Hugging Face defines it) and
computed in float32 (TF32 off), from the weights of ``inputs/weights.py``
by name.  Nothing of the port is imported or read.

- Patch encoder: an MLP (LeakyReLU 0.01) of each flattened 16x16x3 patch,
  plus three learned position tables (x, y, t).
- OPT backbone on ``inputs_embeds``: ``project_in`` where the embedding
  width differs, learned positions ``cumsum(valid) - 1`` at offset 2,
  blocks pre-LN or post-LN (``do_layer_norm_before``), causal attention,
  ReLU MLP, a final LayerNorm with pre-LN, ``project_out``.  Dropout at the
  embedding stream, after the attention output and after the MLP, and on
  the adapters' input.  The rollout keeps only valid tokens (an invalid
  token is no key of a valid one), so it needs no mask but the causal one.
- DoRA on the q and v projections: ``y = m * (x W^T + s (x' A) B) / ||W +
  s (A B)^T||_row + b`` with the norm detached (training, unmerged), or the
  merged weight ``m (W + s (AB)^T) / ||.||_row`` (rollout).
- MLPGNN decoder: a Softplus MLP of each token to 16x16x32 pixel features,
  folded onto the grid, then GATv2 convs over the 4-neighbour grid with
  self loops (softmax over the slots that exist), Softplus between them.
- Output: per-pixel diffs times ``diff_scale_factor``.

``Arith`` is where the precision lives: float32 for the reference; for its
control, the step below the bfloat16 that the configuration states: every
activation that the port keeps in bfloat16 (the residual stream, norms'
and projections' outputs, attention probabilities, the decoder's features)
rounded to float8 e4m3 with one scale a tensor, its gradient alike, and
every matrix product's operands too; sums, norms and softmax in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SHIFTS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its absolute maximum to
    448), back in float32."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _Fp8Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


class Arith:
    """``control``: the float8 rounding above; ``bf16``: the configuration's
    own precision, activations and products' operands rounded to bfloat16
    (the yardstick of how far rounding alone moves a result)."""

    def __init__(self, control: bool = False, bf16: bool = False):
        self.control, self.bf16 = control, bf16

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the precision stores it."""
        if self.bf16:
            return x.to(torch.bfloat16).float()
        return _Fp8Act.apply(x) if self.control else x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``; ``b`` 2-D (a weight) or of ``a``'s batch shape."""
        if self.bf16:
            return self.act(a) @ self.act(b)
        if not self.control:
            return a @ b
        if b.dim() == 2:
            return _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], -1)
        return _Fp8Matmul.apply(a, b)

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return self.act(y if b is None else y + b)


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def targets(conf: dict) -> list[str]:
    """The adapted attention projections, in the order a block applies them."""
    names = {t.split("_")[0] for t in conf["fluid_llm"]["lora_config"]["target_modules"]}
    if not names <= set("qkvo"):
        raise ValueError(f"adapters on {sorted(names)}: the reference adapts q, k, v, o only")
    return [n for n in "qkvo" if n in names]


def layer_norm(x, W, name, eps, ar=None):
    y = F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"], W[f"{name}.bias"], eps)
    return y if ar is None else ar.act(y)


class Model:
    """The reference over a dict of weights ``W`` (names of
    ``inputs/weights.spec``).  ``train`` selects the unmerged adapters;
    otherwise :meth:`merge` folds them first."""

    def __init__(self, conf: dict, geo: dict, W: dict, ar: Arith):
        self.conf, self.geo, self.W, self.ar = conf, geo, W, ar
        bb, fl = conf["backbone"], conf["fluid_llm"]
        self.bb, self.fl = bb, fl
        self.d, self.de, self.H = bb["hidden_size"], bb["word_embed_proj_dim"], \
            bb["num_attention_heads"]
        self.L = bb["num_hidden_layers"]
        self.eps = conf["family_constants"]["layer_norm_eps"]
        self.offset = conf["family_constants"]["position_offset"]
        self.rate = bb["dropout"]
        self.lora_rate = fl["lora_config"]["lora_dropout"]
        self.scaling = fl["lora_config"]["lora_alpha"] / fl["lora_config"]["r"]
        self.targets = targets(conf)
        self.merged = False

    # -- adapters ------------------------------------------------------------

    def merge(self) -> None:
        """Fold every adapter into its base weight (the rollout's weights)."""
        W = self.W
        for i in range(self.L):
            for t in self.targets:
                p, base = f"lora.layers.{i}.attn.{t}", f"backbone.layers.{i}.attn.{t}.weight"
                w = W[base] + (W[f"{p}.A"] @ W[f"{p}.B"] * self.scaling).t()
                W[base] = w * (W[f"{p}.m"] / w.norm(dim=1))[:, None]
        self.merged = True

    def proj(self, x, i, name, keep=None):
        W, ar = self.W, self.ar
        base = f"backbone.layers.{i}.attn.{name}"
        y = ar.linear(x, W[f"{base}.weight"])
        if name in self.targets and not self.merged:
            p = f"lora.layers.{i}.attn.{name}"
            xd = dropout(x, keep, self.lora_rate)
            y = y + ar.matmul(ar.matmul(xd, W[f"{p}.A"]), W[f"{p}.B"]) * self.scaling
            with torch.no_grad():
                norm = (W[f"{base}.weight"] + (W[f"{p}.A"] @ W[f"{p}.B"] * self.scaling).t()) \
                    .norm(dim=1)
            y = ar.act(y * (W[f"{p}.m"] / norm))
        return ar.act(y + W[f"{base}.bias"])

    # -- parts -----------------------------------------------------------------

    def embed(self, states, pos, keep=None):
        """states (B, F, N, 3, px, py), pos (B, F, N, 3) -> (B, F*N, de)."""
        W, ar = self.W, self.ar
        h = states.flatten(3)
        n = len([k for k in W if k.startswith("input_emb.patch.mlp.") and k.endswith(".weight")])
        for j in range(n):
            h = ar.linear(h, W[f"input_emb.patch.mlp.{j}.weight"], W[f"input_emb.patch.mlp.{j}.bias"])
            if j < n - 1:
                h = F.leaky_relu(h, 0.01)
        h = h + W["input_emb.pos.x"][pos[..., 0]] + W["input_emb.pos.y"][pos[..., 1]] \
            + W["input_emb.pos.t"][pos[..., 2]]
        h = dropout(h, keep, self.fl["pos_embedding_params"]["input_emb_layer_dropout"])
        return ar.act(h.reshape(h.shape[0], -1, h.shape[-1]))

    def attention(self, q, k, v):
        B, L, _ = q.shape
        hd = self.d // self.H
        q, k, v = (t.reshape(B, L, self.H, hd).transpose(1, 2) for t in (q, k, v))
        s = self.ar.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        p = self.ar.act(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1))
        return self.ar.act(self.ar.matmul(p, v).transpose(1, 2).reshape(B, L, self.d))

    def block(self, x, i, keeps=None):
        """One block; ``keeps``: its four dropout masks in draw order (the
        adapters' inputs by target, after attention, after the MLP)."""
        W, ar = self.W, self.ar
        pre = self.bb["do_layer_norm_before"]
        kq = dict(zip(self.targets, keeps[:len(self.targets)])) if keeps else {}
        k_attn, k_mlp = (keeps[-2], keeps[-1]) if keeps else (None, None)
        p = f"backbone.layers.{i}"
        h = layer_norm(x, W, f"{p}.ln1", self.eps, ar) if pre else x
        q, k, v = (self.proj(h, i, n, kq.get(n)) for n in "qkv")
        a = self.proj(self.attention(q, k, v), i, "o", kq.get("o"))
        x = ar.act(x + dropout(a, k_attn, self.rate))
        if not pre:
            x = layer_norm(x, W, f"{p}.ln1", self.eps, ar)
        h = layer_norm(x, W, f"{p}.ln2", self.eps, ar) if pre else x
        h = ar.linear(ar.act(torch.relu(ar.linear(h, W[f"{p}.mlp.fc1.weight"],
                                                  W[f"{p}.mlp.fc1.bias"]))),
                      W[f"{p}.mlp.fc2.weight"], W[f"{p}.mlp.fc2.bias"])
        x = ar.act(x + dropout(h, k_mlp, self.rate))
        if not pre:
            x = layer_norm(x, W, f"{p}.ln2", self.eps, ar)
        return x

    def backbone(self, x, keeps=None):
        """x (B, L, de), every token valid -> (B, L, de); ``keeps``: the
        stream's mask, then each block's four."""
        W, ar = self.W, self.ar
        if self.de != self.d:
            x = ar.linear(x, W["backbone.project_in.weight"])
        L = x.shape[1]
        x = ar.act(x + W["backbone.pos_embed"][torch.arange(L, device=x.device) + self.offset])
        x = dropout(x, keeps[0] if keeps else None, self.rate)
        per = len(self.targets) + 2
        for i in range(self.L):
            x = self.block(x, i, keeps[1 + per * i:1 + per * (i + 1)] if keeps else None)
        if self.bb["do_layer_norm_before"]:
            x = layer_norm(x, W, "backbone.final_norm", self.eps, ar)
        if self.de != self.d:
            x = ar.linear(x, W["backbone.project_out.weight"])
        return x

    def slot_attention(self, xl, xr, att):
        """GATv2's attention over each pixel and its four grid neighbours."""
        X, Y = xl.shape[-3], xl.shape[-2]
        pad = F.pad(xl, (0, 0, 1, 1, 1, 1))
        xs = torch.arange(X, device=xl.device)[:, None]
        ys = torch.arange(Y, device=xl.device)[None, :]
        logits, vals = [], []
        for dx, dy in SHIFTS:
            v = pad[..., 1 + dx:1 + dx + X, 1 + dy:1 + dy + Y, :]
            lg = (F.leaky_relu(xr + v, 0.2) * att).sum(-1)
            inside = (xs + dx >= 0) & (xs + dx < X) & (ys + dy >= 0) & (ys + dy < Y)
            logits.append(lg.masked_fill(~inside, float("-inf")))
            vals.append(v)
        a = torch.softmax(torch.stack(logits, -1), -1)
        return sum(a[..., s, None] * vals[s] for s in range(len(SHIFTS)))

    def decode(self, tok):
        """tok (B, F, N, de) -> diffs (B, F, 3, X, Y)."""
        W, ar, geo = self.W, self.ar, self.geo
        dec = self.fl["decoder_params"]
        h = ar.act(F.softplus(ar.linear(tok, W["decoder.mlp.0.weight"], W["decoder.mlp.0.bias"])))
        h = ar.linear(h, W["decoder.mlp.1.weight"], W["decoder.mlp.1.bias"])
        B, Fr = tok.shape[:2]
        (px, py), nx, ny, g = geo["patch"], geo["nx"], geo["ny"], dec["gnn_dim"]
        x = h.reshape(B, Fr, nx, ny, g, px, py).permute(0, 1, 2, 5, 3, 6, 4) \
            .reshape(B, Fr, nx * px, ny * py, g)
        convs = [f"decoder.gnn.convs.{i}" for i in range(dec["gnn_layers"] - 1)] + ["decoder.gnn.out"]
        for j, c in enumerate(convs):
            xl = ar.linear(x, W[f"{c}.lin_l.weight"], W[f"{c}.lin_l.bias"])
            xr = ar.linear(x, W[f"{c}.lin_r.weight"], W[f"{c}.lin_r.bias"])
            x = ar.act(self.slot_attention(xl, xr, W[f"{c}.att"][0]) + W[f"{c}.bias"])
            if j < len(convs) - 1:
                x = ar.act(F.softplus(x))
        return x.permute(0, 1, 4, 2, 3) * self.fl["diff_scale_factor"]

    def with_bos(self, h):
        bos = self.W["bos"].expand(h.shape[0], 1, h.shape[-1])
        return torch.cat([bos, h], 1)
