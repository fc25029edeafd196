"""FLUID-LLM's weights, made on the device from a seed, by parameter name.

The names and shapes follow the port's ``FluidLLM`` state dict (which loads
them by name) and are worked out here from the configuration file alone, so
that the reference gets the same tensors without the program.  The values
stand for a trained model: every bias, norm and adapter is drawn away from
its initial value (LoRA's ``B`` is not zero, DoRA's ``m`` is not the plain
column norm), so that every term of the forward does work.  All tensors are
float32, the type the model keeps its weights in; two draws on the card
(one normal, one uniform) fill them all.
"""

from __future__ import annotations

import math

import torch

from portbench.inputs.cylinder import HEIGHT, LENGTH


def grid_shape(resolution: int) -> tuple[int, int]:
    """Pixels of the channel's grid: the long axis gets ``resolution``, the
    short one the aspect ratio of it, truncated (``mesh_utils.grid_pos``)."""
    return resolution, int(resolution * (HEIGHT / LENGTH))


def geometry(conf: dict) -> dict:
    """The patch grid of a configuration: the channel's pixels padded to
    whole patches, centred."""
    fl = conf["fluid_llm"]
    px, py = fl["patch_size"]
    h, w = grid_shape(fl["resolution"])
    H, W = h + (-h % px), w + (-w % py)
    return dict(grid=(h, w), padded=(H, W), pad_x=((H - h) // 2, H - h - (H - h) // 2),
                pad_y=((W - w) // 2, W - w - (W - w) // 2), nx=H // px, ny=W // py,
                patch=(px, py), n_patch=(H // px) * (W // py), frame_pixels=H * W,
                patch_pixels=px * py, t_table=fl["autoreg_seq_len"] - 1 + int(fl["see_init_state"]))


def spec(conf: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, rule, scale) of every weight.  Rules: ``normal``
    N(0, scale); ``one`` 1 + N(0, scale); ``uniform`` U(-scale, scale);
    ``dora_m`` DoRA's magnitude, worked out from its base and adapter."""
    bb, fl = conf["backbone"], conf["fluid_llm"]
    g = geometry(conf)
    d, de, ff = bb["hidden_size"], bb["word_embed_proj_dim"], bb["ffn_dim"]
    r = fl["lora_config"]["r"]
    targets = [t.split("_")[0] for t in fl["lora_config"]["target_modules"]]  # q_proj -> q
    enc, dec = fl["encoder_params"], fl["decoder_params"]
    out: list[tuple[str, tuple[int, ...], str, float]] = []

    def linear(name, n_in, n_out, rule="normal", scale=0.02, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), rule, scale))
        if bias:
            out.append((f"{name}.bias", (n_out,), "normal", 0.02))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "one", 0.05))
        out.append((f"{name}.bias", (n,), "normal", 0.02))

    for i in range(bb["num_hidden_layers"]):
        p = f"backbone.layers.{i}"
        norm(f"{p}.ln1", d)
        for name in "qkvo":
            linear(f"{p}.attn.{name}", d, d)
        norm(f"{p}.ln2", d)
        linear(f"{p}.mlp.fc1", d, ff)
        linear(f"{p}.mlp.fc2", ff, d)
    if bb["do_layer_norm_before"]:
        norm("backbone.final_norm", d)
    if de != d:
        linear("backbone.project_in", de, d, bias=False)
        linear("backbone.project_out", d, de, bias=False)
    out.append(("backbone.pos_embed", (bb["max_position_embeddings"] + 2, d), "normal", 0.02))

    widths = [g["patch_pixels"] * 3] + [enc["hidden_dim"]] * (enc["num_layers"] - 1) + [de]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        linear(f"input_emb.patch.mlp.{i}", a, b, "uniform", 1.0 / math.sqrt(a))
    for axis, n in (("x", g["nx"]), ("y", g["ny"]), ("t", g["t_table"])):
        out.append((f"input_emb.pos.{axis}", (n, de), "normal", 1.0))

    hid, gnn = dec["mlp_hid_dim"], dec["gnn_dim"]
    linear("decoder.mlp.0", de, hid, "uniform", 1.0 / math.sqrt(de))
    linear("decoder.mlp.1", hid, g["patch_pixels"] * gnn, "uniform", 1.0 / math.sqrt(hid))
    convs = [gnn] + [dec["gnn_hid_dim"]] * (dec["gnn_layers"] - 1) + [3]
    for i, (a, b) in enumerate(zip(convs[:-1], convs[1:])):
        p = f"decoder.gnn.convs.{i}" if i < len(convs) - 2 else "decoder.gnn.out"
        for side in ("lin_l", "lin_r"):
            linear(f"{p}.{side}", a, b, "uniform", math.sqrt(6.0 / (a + b)))
        out.append((f"{p}.att", (1, b), "uniform", math.sqrt(6.0 / (1 + b))))
        out.append((f"{p}.bias", (b,), "normal", 0.02))
    out.append(("bos", (de,), "normal", 0.02))

    for i in range(bb["num_hidden_layers"]):
        for name in targets:
            p = f"lora.layers.{i}.attn.{name}"
            out.append((f"{p}.A", (d, r), "uniform", 1.0 / math.sqrt(d)))
            out.append((f"{p}.B", (r, d), "normal", 0.02))
            out.append((f"{p}.m", (d,), "dora_m", 0.05))
    return out


def make(conf: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every weight of ``spec`` as a float32 tensor on ``device``."""
    entries = spec(conf)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    n_normal = sum(math.prod(s) for _, s, rule, _ in entries if rule in ("normal", "one"))
    n_uniform = sum(math.prod(s) for _, s, rule, _ in entries if rule in ("uniform", "dora_m"))
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, i_n, i_u = {}, 0, 0
    scaling = conf["fluid_llm"]["lora_config"]["lora_alpha"] / conf["fluid_llm"]["lora_config"]["r"]
    for name, shape, rule, scale in entries:
        n = math.prod(shape)
        if rule in ("normal", "one"):
            t = normal[i_n:i_n + n].view(shape) * scale
            i_n += n
            out[name] = t + 1.0 if rule == "one" else t
        else:
            u = uniform[i_u:i_u + n].view(shape)
            i_u += n
            if rule == "uniform":
                out[name] = u * scale
            else:  # the row norm of the adapted weight, scaled by 1 +- scale
                base = name.rsplit(".", 1)[0]  # lora.layers.i.attn.q
                _, _, li, _, proj = base.split(".")
                w = out[f"backbone.layers.{li}.attn.{proj}.weight"]
                w_eff = w + (out[f"{base}.A"] @ out[f"{base}.B"] * scaling).T
                out[name] = w_eff.norm(dim=1) * (1.0 + scale * u)
    return out
