"""The comparison that decides ``correct``: the reference's run and the numbers.

Training: the reference follows the program's first three steps from the
same weights, rows and dropout masks (drawn in the program's order from a
generator seeded alike: the masks are inputs both sides draw the same way)
with its own data layer, loss and AdamW.  Compared (by the worst leaf; the
gap between the two sides' norms, over the reference's norm of that leaf or
of the median leaf, whichever is larger):

- ``loss_gap``: the first step's loss, relative;
- ``grad_gap`` and ``grad_median_gap``: the first gradient as the optimizer
  got it (the program's from AdamW's first moment after one step), by the
  worst leaf and the median leaf;
- ``delta_gap``: the change of every trained leaf over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's.

Rollout: the data layer's first frame (``data_gap``, relative L2) and the
sampled trajectories' steps (``step_ratio``): the reference predicts every
step from the program's own window of states, as a served model is judged
on its own tokens, and so does the same reference rounded to bfloat16; a
trajectory's answer is the L2 gap of the program's diffs from the
reference's over its steps, divided by the bfloat16 reference's gap; the
worst trajectory.  How far bf16 rounding moves a step depends on the
seed's weights (the program's gap alone read 0.002-0.016 over 44 seeds),
so the program is held to what rounding at its precision does to the
same steps; one answer altered still moves its trajectory's gap.

The reference runs on the device it is given, in blocks of rows, TF32 off.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.reference.data import Data, to_patches
from portbench.reference.model import Arith, Model, targets


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- training ----------------------------------------------------------------

def draw_keeps(conf: dict, gen: torch.Generator, shapes: dict, device) -> list:
    """The step's dropout keep-masks in the order the model draws them: the
    input embeddings, the backbone's stream, then per block each adapter's
    input, after attention, after the MLP.  A rate of 0 draws nothing."""
    bb, fl = conf["backbone"], conf["fluid_llm"]

    def keep(shape, rate):
        if rate == 0.0:
            return None
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate

    out = [keep(shapes["embed"], fl["pos_embedding_params"]["input_emb_layer_dropout"]),
           keep(shapes["stream"], bb["dropout"])]
    for _ in range(bb["num_hidden_layers"]):
        out += [keep(shapes["stream"], fl["lora_config"]["lora_dropout"]) for _ in targets(conf)]
        out += [keep(shapes["stream"], bb["dropout"]), keep(shapes["stream"], bb["dropout"])]
    return out


def rows_of(keeps: list, rows: slice) -> list:
    return [None if k is None else k[rows] for k in keeps]


def train_batch(data: Data, rows: list[tuple[int, int]], seq_len: int, device) -> dict:
    ws = [data.window(i, s, seq_len) for i, s in rows]
    return {k: torch.stack([w[k] for w in ws]).to(device) for k in ("inputs", "targets", "mask", "pos")}


def train_loss_sums(model: Model, b: dict, keeps: list, conf: dict) -> dict:
    """Forward of some rows: the masked sums of each loss over velocity and
    pressure (their counts are the whole batch's)."""
    fl, geo = conf["fluid_llm"], model.geo
    states = to_patches(b["inputs"], geo)  # (b, S, N, 3, px, py)
    pos = b["pos"]
    states = torch.cat([states[:, :1], states], 1)  # see-init: frame 0 again
    pos = torch.cat([pos[:, :1], pos], 1)
    h = model.with_bos(model.embed(states, pos, keeps[0]))
    out = model.backbone(h, keeps[1:])[:, 1:]
    B, S = states.shape[:2]
    diff = model.decode(out.reshape(B, S, geo["n_patch"], -1))[:, 1:]
    pred, target = b["inputs"] + diff, b["targets"]
    if fl["loss_norm_eps"] is not None:
        d = (b["targets"] - b["inputs"]).reshape(B, -1)
        scale = (d.std(dim=1) + fl["loss_norm_eps"])[:, None, None, None, None]
        pred, target = pred / scale, target / scale
    sel = (~b["mask"])[:, None, None].to(pred.dtype)
    err = pred - target
    sums = {}
    for fn in fl["loss_function"]:
        e = {"mae": err.abs(), "mse": err * err}[fn]
        sums[fn] = ((e[:, :, :2] * sel).sum(), (e[:, :, 2:] * sel).sum())
    return sums


def reference_train(conf: dict, traffic: dict, geo: dict, W: dict, data: Data,
                    steps_rows: list[list[tuple[int, int]]], dropout_seed: int, device,
                    control: bool = False, chunk: int = 4) -> dict:
    """The reference's steps from weights ``W`` (modified in place): each
    step's loss, the first gradient's norm and the change of each leaf."""
    no_tf32()
    fl = conf["fluid_llm"]
    ar = Arith(control)
    model = Model(conf, geo, W, ar)
    names = [n for n in W if not n.startswith("backbone.")]
    init = {n: W[n].detach().clone() for n in names}
    for n in names:
        W[n].requires_grad_(True)
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(dropout_seed))
    lr, wd, (b1, b2), eps = fl["learning_rate"], fl["weight_decay"], (0.9, 0.999), 1e-8
    frames = traffic["seq_len"] - 1 + int(fl["see_init_state"])
    losses, grad_norms = [], {}
    for t, rows in enumerate(steps_rows, start=1):
        batch = train_batch(data, rows, traffic["seq_len"], device)
        B = len(rows)
        L = frames * geo["n_patch"] + int(fl["use_bos_token"])
        keeps = draw_keeps(conf, gen, dict(embed=(B, frames, geo["n_patch"],
                                                  conf["backbone"]["word_embed_proj_dim"]),
                                           stream=(B, L, conf["backbone"]["hidden_size"])), device)
        unmasked = (~batch["mask"]).sum().item() * (traffic["seq_len"] - 1)
        counts = (2.0 * unmasked, 1.0 * unmasked)
        loss_val = 0.0
        for s in range(0, B, chunk):
            rows_s = slice(s, min(s + chunk, B))
            sums = train_loss_sums(model, {k: x[rows_s] for k, x in batch.items()},
                                   rows_of(keeps, rows_s), conf)
            loss = 0.0
            for fn, w in zip(fl["loss_function"], fl["loss_weighting"]):
                sv, sp = sums[fn]
                loss = loss + w * (sv / counts[0] + fl["pressure_weight"] * sp / counts[1])
            loss.backward()
            loss_val += float(loss.detach())
        del keeps
        losses.append(loss_val)
        with torch.no_grad():
            if t == 1:
                grad_norms = {n: float(W[n].grad.norm()) for n in names}
            for n in names:
                g = W[n].grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                W[n].mul_(1 - lr * wd)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                W[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                W[n].grad = None
    deltas = {n: float((W[n].detach() - init[n]).norm()) for n in names}
    return dict(losses=losses, grad_norms=grad_norms, deltas=deltas)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's); ``keep``: the leaves that count.  A leaf the program lacks, or
    whose norm is not finite, reads 1."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        p = prog.get(n)
        out[n] = 1.0 if p is None or not math.isfinite(p) \
            else abs(p - ref[n]) / max(ref[n], med, 1e-30)
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: losses, grad_norms, deltas.

    - ``loss_gap``: the first step's loss, relative.  Later steps' losses
      swing from seed to seed with the rounding that AdamW's normalised
      first updates carry into the weights, so they are reported, not
      compared;
    - ``grad_gap``: the worst leaf's first gradient;
    - ``grad_median_gap``: the median leaf's: steady, and what a batch of
      other rows moves (half a batch changes every leaf's gradient a little,
      no leaf's by much);
    - ``delta_gap``: the worst leaf's change over the steps."""
    pl, rl = prog["losses"], ref["losses"]
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else 1.0 for p, r in zip(pl, rl)]
    loss_gap = gaps[0] if gaps and len(pl) == len(rl) else 1.0
    med = statistics.median(ref["grad_norms"].values())
    moved = {n for n, g in ref["grad_norms"].items() if g >= 1e-3 * med}
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    delta = leaf_gaps(prog["deltas"], ref["deltas"], moved)
    g_at, d_at = max(grad, key=grad.get), max(delta, key=delta.get)
    return dict(loss_gap=loss_gap, grad_gap=grad[g_at],
                grad_median_gap=statistics.median(grad.values()), delta_gap=delta[d_at],
                _where="loss by step " + " ".join(f"{g:.3g}" for g in gaps)
                       + f"; grad {g_at}; delta {d_at}; {len(ref['deltas']) - len(moved)} "
                       "leaves left out of the change")


# -- rollout -----------------------------------------------------------------

def spatial_pos(geo: dict, device) -> torch.Tensor:
    a = torch.arange(geo["n_patch"], device=device)
    return torch.stack([a % geo["nx"], (a // geo["nx"]) % geo["ny"]], -1)  # (N, 2)


@torch.no_grad()
def reference_step_diffs(model: Model, windows: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """windows (b, n, 3, X, Y): the valid frames of the rollout's window,
    oldest first; masks (b, X, Y).  -> the diff to the next frame."""
    geo = model.geo
    b, n = windows.shape[:2]
    frames = torch.cat([windows[:, :1], windows], 1)  # see-init: the first valid frame again
    states = to_patches(frames, geo)
    sp = spatial_pos(geo, windows.device)
    t = torch.cat([torch.zeros(1, dtype=torch.long), torch.arange(n)]).to(windows.device)
    pos = torch.cat([sp[None].expand(n + 1, -1, -1),
                     t[:, None, None].expand(n + 1, geo["n_patch"], 1)], -1)
    h = model.with_bos(model.embed(states, pos[None].expand(b, -1, -1, -1)))
    out = model.backbone(h)[:, -geo["n_patch"]:]
    diff = model.decode(out[:, None])[:, 0]
    return torch.where(masks[:, None], torch.zeros((), device=diff.device), diff)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def rollout_numbers(model: Model, rounded: Model, data: Data, picks: list[tuple[int, torch.Tensor]],
                    window: int, start: int, device, block: int = 16) -> dict:
    """``picks``: (trajectory, the program's states (S, 3, X, Y)) of the
    sampled rollouts.  The reference (``model``) judges each step of each
    from the program's window before it; ``rounded``, the same reference in
    bfloat16, says how far rounding alone moves that step."""
    no_tf32()
    data_gap = 0.0
    jobs = []  # (n, trajectory, step, window, mask, program diff)
    for idx, states in picks:
        img, mask = data.frames(idx, start, 1)
        states = states.to(device).float()
        mask = mask.to(device)
        g = rel(states[0], img[0].to(device))
        if not math.isfinite(g) or g > data_gap:
            data_gap = g if math.isfinite(g) else math.inf
        for i in range(states.shape[0] - 1):
            lo = max(0, i + 1 - window)
            jobs.append((i + 1 - lo, idx, i, states[lo:i + 1], mask, states[i + 1] - states[i]))
    errs = []  # (|program - reference|, |reference|, trajectory, step)
    for n in sorted({j[0] for j in jobs}):
        group = [j for j in jobs if j[0] == n]
        for s in range(0, len(group), block):
            part = group[s:s + block]
            windows, masks = torch.stack([j[3] for j in part]), torch.stack([j[4] for j in part])
            ref = reference_step_diffs(model, windows, masks)
            low = reference_step_diffs(rounded, windows, masks)
            for j, r, b in zip(part, ref, low):
                e = float((j[5] - r).norm())
                errs.append((e if math.isfinite(e) else math.inf, float(r.norm()), j[1], j[2] + 1,
                             float((b - r).norm())))
    per: dict[int, list[tuple[float, float]]] = {}
    for e, _, i, _, b in errs:
        per.setdefault(i, []).append((e, b))
    ratio = {i: math.sqrt(sum(e * e for e, _ in v)) / max(math.sqrt(sum(b * b for _, b in v)), 1e-30)
             for i, v in per.items()}
    traj = max(ratio, key=ratio.get)
    total = math.sqrt(sum(e[0] ** 2 for e in errs)) / math.sqrt(sum(e[1] ** 2 for e in errs))
    rounding = math.sqrt(sum(e[4] ** 2 for e in errs)) / math.sqrt(sum(e[1] ** 2 for e in errs))
    return dict(data_gap=data_gap, step_ratio=ratio[traj],
                _where=f"step_ratio: trajectory {traj}; all steps: program {total:.4g}, bf16 "
                       f"reference {rounding:.4g} of the reference's norm; {len(errs)} steps of "
                       f"{len(per)} trajectories")
