"""chip_smoke.py's MoE agreement checks at several seeds.

    python fluid_llm_tpu_torch/tools/moe_seeds.py --seeds 1234 7 --out FILE.json

Run it as a script from the repo root, on one CUDA card.  It builds the
kernels, then for each seed runs ``phase_moe_rollout`` (moe_cylinder.yaml:
kernels vs twins, each routing itself and the twins routed from the
kernels' probabilities) and ``phase_moe_streaming`` (the flagship with a
MoE MLP: streaming vs the banded dense forward, likewise), and writes each
seed's errors, bounds, |MoE out| / |block out| per layer and shares of
tokens routed to another expert set, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

KEYS = ("agreement_rel_err", "agreement_bound", "rho_step1", "replayed_rel_err",
        "flip_share_step1", "banded_rel_err", "banded_bound", "banded_rho",
        "banded_replayed_rel_err", "banded_twin_rel_err", "streamed_kernels_vs_twins",
        "banded_flip_share")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1234, 7])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("moe_seeds: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    device = cs.phase_device()
    cs.phase_build()
    failures, res = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            got = {}
            for fn in (cs.phase_moe_rollout, cs.phase_moe_streaming):
                got.update(fn(dev, seed, failures, tmp))
            res[seed] = {k: got[k] for k in KEYS}
    print(json.dumps(dict(device=device["smi"], seeds=res, failures=failures)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=device, seeds=res, failures=failures), f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
