"""Micro-benchmark: the flash attention kernels against their plain twin.

Counterpart of ``fluid_llm_tpu/tools/flash_bench.py``.  Times the forward
(``ops/flash_attention.flash_forward``: the exact-window kernel writing
``lse``) and forward + backward (``FlashAttention``: the forward, then the
dq and dk/dv kernels) against the plain twins (``flash_forward_ref``,
``flash_backward_ref``) at 12 heads x 64, bf16, ``valid = arange(L) <
L - 13``, over sequence lengths: where the kernels' lead over plain
attention stands as L grows.

    python -m fluid_llm_tpu_torch.tools.flash_bench [bs] [lengths...] [--device cuda]

Defaults: bs 1, L 661 1536 4096 8192.  On the card each figure is the mean
of ``reps`` calls timed with CUDA events after a warm call; the twin at
8192 materialises 12 x 8192^2 f32 scores (3.2 GB), so do not ask the CPU
for that length (``--device cpu`` times the twins on both sides: a test of
the tool).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

H, HD = 12, 64


def _time_ms(fn, device: torch.device, reps: int) -> float:
    fn()  # warm: builds and loads the kernels on first use
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def inputs(bs: int, L: int, device: torch.device, seed: int = 0):
    """q, k, v (bs, L, H*HD) bf16 from numpy's normal draw, and validity."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(bs, L, H * HD)).astype(np.float32))
               .to(device, torch.bfloat16) for _ in range(3))
    valid = (torch.arange(L, device=device) < L - 13).to(torch.int32)[None].repeat(bs, 1)
    return q, k, v, valid.contiguous()


def bench_length(bs: int, L: int, device: torch.device, reps: int = 10) -> dict:
    """ms of the plain and kernel forward and forward+backward at ``L``;
    the kernels' output, lse and gradients against the twins' (relative L2
    error; lse the largest absolute difference)."""
    from fluid_llm_tpu_torch.ops import flash_attention as fa

    q, k, v, valid = inputs(bs, L, device)
    dout = torch.ones_like(q)

    def plain_fwd():
        return fa.flash_forward_ref(q, k, v, valid, H, HD)

    def kernel_fwd():
        return fa.flash_forward(q, k, v, valid, H, HD)

    def plain_fb():
        out, lse = fa.flash_forward_ref(q, k, v, valid, H, HD)
        return fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, HD)

    def kernel_fb():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention(qq, kk, vv, valid, H, HD)
        return torch.autograd.grad(out.float().sum(), (qq, kk, vv))

    times = {name: _time_ms(fn, device, reps) for name, fn in
             (("plain_fwd", plain_fwd), ("flash_fwd", kernel_fwd),
              ("plain_fb", plain_fb), ("flash_fb", kernel_fb))}
    (out, lse), (ref, ref_lse) = kernel_fwd(), plain_fwd()
    grads, ref_grads = kernel_fb(), plain_fb()
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    return dict(L=L, bs=bs, **times, rel_out=rel(out, ref),
                lse_err=float((lse - ref_lse).abs().max()),
                rel_grad=max(rel(a, b) for a, b in zip(grads, ref_grads)))


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sizes", nargs="*", type=int, help="bs, then lengths")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flash_bench: CUDA is not available (pass --device cpu to time the "
                         "plain twins on the CPU)")
    bs = args.sizes[0] if args.sizes else 1
    lengths = args.sizes[1:] or [661, 1536, 4096, 8192]
    print(f"bs={bs} H={H} hd={HD} bf16; times in ms")
    print(f"{'L':>6} {'plain fwd':>9} {'flash fwd':>9} {'plain f+b':>9} {'flash f+b':>9} "
          f"{'rel out':>9} {'lse err':>9} {'rel grad':>9}")
    rows = []
    for L in lengths:
        r = bench_length(bs, L, device, args.reps)
        rows.append(r)
        print(f"{L:>6} " + " ".join(f"{r[k]:9.4f}" for k in
                                    ("plain_fwd", "flash_fwd", "plain_fb", "flash_fb"))
              + " " + " ".join(f"{r[k]:9.2e}" for k in ("rel_out", "lse_err", "rel_grad")),
              flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
