"""One turn of a parent-versus-change comparison: chip_smoke.py's phases from the tree at --root.

    python fluid_llm_tpu_torch/tools/turns.py --root DIR --out FILE.json

Run it as a script (not with ``-m``), so that ``chip_smoke`` and
``fluid_llm_tpu_torch`` are imported from DIR, a ``git archive`` of the
commit to measure, and its kernels are built from DIR's sources.  On one
CUDA card it runs ``phase_kernels``, ``phase_rollout`` (the exact 251-step
rollout), ``phase_train`` with the default attention and with
``attn_impl="short"``, and ``phase_graph_baselines`` (MeshGraphNet and
GAT), and writes each kernel row's device time and each cell's device time
a step (profiler; train cells also their largest device items, idle share
and median step ms), with sha256 digests of the outputs of the kernels a
comparison expects unchanged: exact attention, the flash forward, dq and
dk/dv (from the twin's lse), the slab decode in its three cache states,
the slot backward at C 48 and C 3, short attention, the indexed linear,
w8a16 and w8a8 (both held bit for bit to their twins), the segment sum
and gather; and the slot forward held to its twin (relative L2 error,
largest difference, repeat bit for bit) and timed at its main path's four
shapes, since a redesign may sum its logits in another order.  Run the
trees in turns (parent, change, change, parent) within one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

SEED = 1234


def digests(cs, dev) -> dict:
    import torch

    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.ops import indexed_linear as il
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm
    from fluid_llm_tpu_torch.ops import segment_ops as so
    from fluid_llm_tpu_torch.ops import short_attention as sa

    def sha(*ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    g = torch.Generator().manual_seed(0)
    res = {}
    for state in ("wrapped", "first", "prefill"):
        q, cache, key_pos, q0, li = cs._slab_case(dev, state, g)
        res[f"slab_decode {state}"] = sha(da.slab_decode(q, cache["k"], cache["v"], key_pos, q0,
                                                         li, 64))
    for bs, L, n_invalid in ((cs.TRAIN_BS, cs.TRAIN_TOKENS, 0), (1, cs.ROLLOUT_TOKENS, 420)):
        H, hd = 12, 64
        q, k, v, dout = ((torch.randn(bs, L, H * hd, generator=g) * 0.5).to(dev, torch.bfloat16)
                         for _ in range(4))
        valid = (torch.arange(L)[None] >= n_invalid).expand(bs, L).int().contiguous().to(dev)
        res[f"short_attention ({bs},{L})"] = sha(sa.short_attention_fwd(q, k, v, valid, H, hd))
        res[f"exact_attention ({bs},{L})"] = sha(xa.causal_attention(q, k, v, valid, H, hd))
        res[f"flash_forward ({bs},{L})"] = sha(*fa.flash_forward(q, k, v, valid, H, hd))
        out, lse = fa.flash_forward_ref(q, k, v, valid, H, hd)
        delta = fa.row_delta(out, dout, H, hd)
        res[f"flash_dq ({bs},{L})"] = sha(fa.flash_dq(q, k, v, dout, lse, delta, valid, H, hd))
        res[f"flash_dkv ({bs},{L})"] = sha(*fa.flash_dkv(q, k, v, dout, lse, delta, valid, H, hd))
    for C in (48, 3):
        xl, xr, go = (torch.randn(cs.TRAIN_BS * 10, 240, 64, C, generator=g).to(dev, torch.bfloat16)
                      for _ in range(3))
        att = torch.randn(1, C, generator=g).to(dev, torch.bfloat16)
        res[f"grid_slot_attention_bwd (80,240,64,{C})"] = sha(*gf.slot_attention_bwd(xl, xr, att,
                                                                                     go, 1, C))
    w = (torch.randn(12, 2304, 768, generator=g) * 0.02).to(dev, torch.bfloat16)
    x = torch.randn(60, 768, generator=g).to(dev, torch.bfloat16)
    index = torch.arange(12, dtype=torch.int32, device=dev)[5]
    res["indexed_linear (60,768,2304)"] = sha(il.indexed_linear(x, w, None, index))
    for M, K, N in ((60, 768, 768), (60, 2048, 768), (661, 768, 3072)):
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev)
        for mode in ("w8a16", "w8a8"):
            res[f"{mode} ({M},{K},{N})"] = sha(qmm.int8_matmul(x, q, scale, b, mode))
    edges = cs.eagle_edges(dev)
    n = int(edges.max()) + 1
    for col, F in ((0, 128), (1, 128), (0, 2)):
        index = so.SegmentIndex(edges[..., col], n)
        nodes = torch.randn(index.n_rows, F, generator=g).to(dev)
        res[f"segment_gather col {col} F {F}"] = sha(so.segment_gather(nodes, index))
        rows = torch.randn(edges.numel() // 2, F, generator=g).to(dev)
        res[f"segment_sum col {col} F {F}"] = sha(so.segment_sum(rows, index))
    return res


def held_to_twin(cs, dev) -> dict:
    """The slot forward against its twin at its main path's four shapes:
    relative L2 error, largest difference, a second call bit for bit, and
    its device time."""
    import torch

    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

    g = torch.Generator().manual_seed(0)
    res = {}
    for Bf, C in ((1, 48), (cs.TRAIN_BS * 10, 48), (1, 3), (cs.TRAIN_BS * 10, 3)):
        xl, xr = (torch.randn(Bf, 240, 64, C, generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        att = torch.randn(1, C, generator=g).to(dev, torch.bfloat16)
        out = gf.fused_slot_attention(xl, xr, att, 1, C)
        ref = gf.slot_attention_ref(xl, xr, att, 1, C)
        res[f"grid_slot_attention ({Bf},240,64,{C})"] = dict(
            rel=cs.rel_err(out, ref), max_abs_err=(out.float() - ref.float()).abs().max().item(),
            repeat=bool(torch.equal(out, gf.fused_slot_attention(xl, xr, att, 1, C))),
            ms=cs.device_ms(lambda: gf.fused_slot_attention(xl, xr, att, 1, C)))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="the tree to import and build")
    ap.add_argument("--out", required=True, help="JSON file of this turn's numbers")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures: list = []
    cs.phase_build()
    keys = ("kernel", "shape", "main_path", "rel", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "deterministic", "geometry")
    res = {"root": root, "kernels": [{k: r.get(k) for k in keys}
                                     for r in cs.phase_kernels(dev, failures)]}
    roll = cs.phase_rollout(dev, SEED, failures, streaming=False)["profile"]
    res["rollout"] = dict(device_busy_ms_a_step=roll["device_busy_ms"] / roll["steps"],
                          **roll)
    for cell, impl in (("train", "auto"), ("short_train", "short")):
        trainer, batch, train = cs.phase_train(dev, SEED, failures, attn_impl=impl)
        del trainer, batch
        res[cell] = {k: train[k] for k in ("device_busy_ms", "device_ops_per_step", "idle_share",
                                           "median_step_ms", "plain_median_step_ms",
                                           "top_device_ms")}
    with tempfile.TemporaryDirectory() as tmp:
        graph = cs.phase_graph_baselines(dev, SEED, failures, tmp)
    res["graph_mgn"] = {k: graph[k] for k in ("device_busy_ms", "device_ops_per_step",
                                              "idle_share", "median_step_ms", "top_device_ms",
                                              "step_launches")}
    res["digests"] = digests(cs, dev)
    res["held_to_twin"] = held_to_twin(cs, dev)
    res["failures"] = failures
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}, default=str))


if __name__ == "__main__":
    main()
