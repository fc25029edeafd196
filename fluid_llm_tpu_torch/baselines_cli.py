"""Train / eval CLI for the EAGLE-benchmark graph baselines (MeshGraphNet, GAT).

Counterpart of the graph path of ``fluid_llm_tpu/baselines_cli.py``
(``eagle/train_{mgn,gat}.py``, ``eagle/eval_mgn.py``):

    python -m fluid_llm_tpu_torch.baselines_cli --model mgn --dataset_path synthetic \\
        --mesh_nodes 84x42 --epoch 500 [--device cuda] [...]

Protocol as the JAX CLI: Adam (betas 0.9/0.999, eps 1e-8, no weight decay;
``optax.scale_by_adam`` with the lr applied outside) and ExponentialLR
(0.991) stepped after every epoch past the second (``train_mgn.py:124-127,
139-140``, the JAX CLI's ``epoch > 1``); masked MSE on normalised diffs;
fixed val/test windows; rollout eval over ``--horizon_eval`` frames scored
by mesh -> grid N-RMSE (``eagle_utils.py:89-130``) with the per-step CSV.
Nodes are relabeled in RCM order as the JAX CLI does in f32.  Checkpoints
are ``<save_dir>/<model>/<name>.pt`` (``{params, norm}``); ``--epoch 0``
loads one and only evaluates.  ``main`` returns a summary of the run.

``--model graphvit`` / ``dilresnet`` and ``--dtype bf16`` are not ported
yet (ROADMAP Queue 1 item 11) and raise.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from fluid_llm_tpu_torch.data.eagle_mesh import (
    AirfoilGraphDataset,
    EagleDroneDataset,
    EagleMGNDataset,
    collate_graphs,
    iterate_graph_batches,
)
from fluid_llm_tpu_torch.data.reorder import reorder_sample
from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset
from fluid_llm_tpu_torch.models.baselines.base import load_norm
from fluid_llm_tpu_torch.models.baselines.gat import GAT
from fluid_llm_tpu_torch.models.baselines.mgn import MGN, mgn_loss
from fluid_llm_tpu_torch.train.eagle_eval import get_nrmse
from fluid_llm_tpu_torch.train.loop import _profiler
from fluid_llm_tpu_torch.utils import get_device, set_seed

logger = logging.getLogger("fluid_llm_tpu_torch.baselines")

ORDER = "rcm"  # the JAX CLI's f32 node order (``baselines_cli.py:180-185``)
GHOST = 1  # ghost nodes' one-hot value for MGN and GAT (INPUT + WALL: forced)


def build_dataset(args, mode: str, window: int):
    if args.dataset_path == "synthetic":
        kw = {}
        if args.mesh_nodes:
            kw["mesh_nodes"] = tuple(int(v) for v in args.mesh_nodes.lower().split("x"))
        if args.max_steps:
            kw["max_steps"] = args.max_steps
        return SyntheticGraphDataset(n_trajectories=args.n_traj, mode=mode,
                                     window_length=window, **kw)
    if "eagle" in args.dataset_path.lower():
        return EagleDroneDataset(args.dataset_path, mode=mode, window_length=window,
                                 n_cluster=args.n_cluster)
    if "airfoil" in args.dataset_path.lower():
        return AirfoilGraphDataset(args.dataset_path, mode=mode, window_length=window,
                                   n_cluster=args.n_cluster)
    return EagleMGNDataset(args.dataset_path, mode=mode, window_length=window,
                           n_cluster=args.n_cluster)


def build_model(args, device: torch.device):
    """The model drawn from seed 1 (the JAX CLI's ``PRNGKey(1)``; the two
    frameworks' streams differ) and its initial normalizer state."""
    g = torch.Generator().manual_seed(1)
    if args.model == "mgn":
        model = MGN(4, args.n_processor, generator=g)
    else:
        model = GAT(4, args.n_processor, args.n_heads, generator=g)
    model.to(device)
    return model, model.init_norm(device)


def make_optimizer(model, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def to_device(batch: dict, device: torch.device) -> dict:
    """Host batch -> tensors on ``device`` (from pinned memory on CUDA).
    ``collate_graphs`` writes one edge list for every step of a window: it
    is sent once and broadcast over the time axis, so the model builds one
    segment index per edge column for the window."""
    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    out = {k: put(v) for k, v in batch.items() if k not in ("edges", "cluster", "cluster_mask")}
    edges = batch["edges"]
    out["edges"] = put(edges[:, :1]).expand(-1, edges.shape[1], -1, -1)
    return out


def prefetch(batch_iter, device: torch.device, depth: int):
    """Build host batches and start their copies ``depth`` batches ahead on
    a worker thread (the reference's ``DataLoader`` workers); ``depth`` 0 is
    synchronous."""
    if depth <= 0:
        for batch in batch_iter:
            yield to_device(batch, device)
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in batch_iter:
                q.put(to_device(item, device))
            q.put(done)
        except BaseException as e:  # raised again on the consumer's side
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def apply_model(args, model, norm, batch, *, train: bool, generator=None):
    return model.apply(norm, batch["mesh_pos"], batch["edges"], batch["state"],
                       batch["node_type"], train=train, apply_noise=train and args.noise_std > 0,
                       noise_std=args.noise_std, generator=generator)


def train_step(args, model, norm, opt, batch, lr: float, generator):
    """One step (``make_graph_step``): loss and gradient of the window
    rollout with noise, Adam at ``lr``.  Returns (new norm, loss tensor)."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    _, output_hat, target, new_norm = apply_model(args, model, norm, batch, train=True,
                                                  generator=generator)
    loss = mgn_loss(output_hat, target, batch["mask"], w_pressure=args.w_pressure)
    loss.backward()
    opt.step()
    return new_norm, loss.detach()


@torch.no_grad()
def validate_graph(args, model, norm, ds, device) -> float:
    """Mean over samples of the batch losses on ``ds`` (normalizers frozen)."""
    tot, cpt = 0.0, 0
    for b in prefetch(iterate_graph_batches(ds, args.batch_size, shuffle=False,
                                            ghost_type_value=GHOST, reorder=ORDER),
                      device, args.prefetch):
        _, output_hat, target, _ = apply_model(args, model, norm, b, train=False)
        tot += float(mgn_loss(output_hat, target, b["mask"], w_pressure=args.w_pressure))
        cpt += b["mesh_pos"].shape[0]
    return tot / max(cpt, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def eval_graph(args, model, norm, device) -> dict:
    """Rollout over the ``--horizon_eval`` window of every test trajectory,
    mesh -> grid N-RMSE per step, and the per-step CSV (``eval_mgn.py:29-68``)."""
    ds = build_dataset(args, "test", args.horizon_eval)
    rows, rollout_s, steps = [], 0.0, 0
    for i in range(len(ds)):
        sample = reorder_sample(ds[i], ORDER)
        batch = to_device(collate_graphs([sample], sample.mesh_pos.shape[1],
                                         sample.edges.shape[0], 1, GHOST), device)
        _sync(device)
        t0 = time.perf_counter()
        state_hat = apply_model(args, model, norm, batch, train=False)[0]
        _sync(device)
        rollout_s += time.perf_counter() - t0
        steps += state_hat.shape[1] - 1
        n_real = sample.mesh_pos.shape[1]
        nrmse = get_nrmse(batch["state"][:, :, :n_real], state_hat[:, :, :n_real],
                          sample.mesh_pos[0], sample.faces, resolution=args.resolution)
        rows.append(nrmse[0])
        logger.info("traj %d N-RMSE mean %.4g", i, float(nrmse.mean()))
    per_step = np.stack(rows).mean(axis=0)
    logger.info("Overall N-RMSE: %.4g (%d rollout steps in %.2f s, %.1f steps/s)",
                float(per_step.mean()), steps, rollout_s, steps / max(rollout_s, 1e-9))
    csv_path = os.path.join(args.save_dir, args.model, f"{args.name}_nrmse.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "n_rmse"])
        for s, v in enumerate(per_step):
            w.writerow([s, float(v)])
    logger.info("wrote %s", csv_path)
    return dict(n_rmse=per_step, csv=csv_path, n_test=len(ds), eval_steps=steps,
                eval_s=rollout_s)


def checkpoint_path(args) -> str:
    return os.path.join(args.save_dir, args.model, f"{args.name}.pt")


def save_params(path: str, model, norm) -> None:
    torch.save({"params": model.state_dict(), "norm": norm}, path)


def load_params(path: str, model, norm_like) -> dict:
    """Loads the parameters into ``model`` and returns the normalizer
    state, both checked strictly."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["params"])
    return load_norm(norm_like, payload["norm"])


def run_graph_model(args) -> dict:
    device = get_device(args.device)
    set_seed(1)
    train_ds = build_dataset(args, "train", args.horizon_train)
    valid_ds = build_dataset(args, "valid", args.horizon_val)
    model, norm = build_model(args, device)
    opt = make_optimizer(model, args.lr)
    noise = torch.Generator(device=device).manual_seed(1)
    os.makedirs(os.path.join(args.save_dir, args.model), exist_ok=True)
    ckpt = checkpoint_path(args)
    lr = args.lr
    summary = dict(train_steps=0, val_loss=[], epoch_s=[], train_loss=[])
    for epoch in range(args.epoch):
        t_ep, n_steps, prof = time.perf_counter(), 0, None
        for batch in prefetch(iterate_graph_batches(train_ds, args.batch_size, shuffle=True,
                                                    seed=epoch, ghost_type_value=GHOST,
                                                    reorder=ORDER),
                              device, args.prefetch):
            if args.profile_dir and epoch == 0 and n_steps == 2:
                _sync(device)  # steps 2-5 of the first epoch, warm
                prof = _profiler(args.profile_dir, device)
                prof.start()
            norm, loss = train_step(args, model, norm, opt, batch, lr, noise)
            n_steps += 1
            if prof is not None and n_steps == 6:
                _stop_profile(prof, device, n_steps - 2, args.profile_dir)
                prof = None
        if prof is not None:  # an epoch shorter than the capture window
            _stop_profile(prof, device, n_steps - 2, args.profile_dir)
        summary["train_loss"].append(float(loss) if n_steps else None)
        dt = time.perf_counter() - t_ep
        if epoch > 1:
            lr *= 0.991  # ExponentialLR(0.991) (``train_mgn.py:126,139-140``)
        val_loss = validate_graph(args, model, norm, valid_ds, device)
        logger.info("=== EPOCH %d === loss=%.4g lr=%.3g (%d steps, %.2fs, %.1f steps/s)",
                    epoch + 1, val_loss, lr, n_steps, dt, n_steps / max(dt, 1e-9))
        save_params(ckpt, model, norm)
        summary["train_steps"] += n_steps
        summary["val_loss"].append(val_loss)
        summary["epoch_s"].append(dt)
    if args.epoch == 0:
        norm = load_params(ckpt, model, norm)
    summary.update(eval_graph(args, model, norm, device), checkpoint=ckpt)
    return summary


def _stop_profile(prof, device, n_steps: int, profile_dir: str) -> None:
    _sync(device)
    prof.stop()
    key = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    logger.info("profile of %d train steps (trace in %s):\n%s", n_steps, profile_dir,
                prof.key_averages().table(sort_by=key, row_limit=15))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=["mgn", "gat", "graphvit", "dilresnet"], required=True)
    parser.add_argument("--epoch", type=int, default=500)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--dataset_path", default="synthetic")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--w_pressure", type=float, default=0.1)
    parser.add_argument("--alpha", type=float, default=0.1)
    parser.add_argument("--horizon_val", type=int, default=5)
    parser.add_argument("--horizon_train", type=int, default=5)
    # reference eval horizons: MGN 101-step windows (``eval_mgn.py:29``)
    parser.add_argument("--horizon_eval", type=int, default=None)
    parser.add_argument("--n_processor", type=int, default=15)
    parser.add_argument("--n_heads", type=int, default=4)
    parser.add_argument("--n_cluster", type=int, default=10)
    parser.add_argument("--w_size", type=int, default=512)
    parser.add_argument("--noise_std", type=float, default=2e-2)
    parser.add_argument("--resolution", type=int, default=238)
    parser.add_argument("--n_traj", type=int, default=4, help="synthetic trajectories")
    parser.add_argument("--mesh_nodes", default=None,
                        help="synthetic mesh grid 'NXxNY' (default 24x10; EAGLE geometry "
                             "is ~3.5k nodes -> 84x42)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="synthetic trajectory length in frames (default 200)")
    parser.add_argument("--name", default="run")
    parser.add_argument("--profile_dir", default=None,
                        help="torch.profiler trace of train steps 2-5 of epoch 0 and a "
                             "per-op table in the log")
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                        help="compute dtype; only f32 is ported")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches built and copied ahead on a worker thread; 0 = "
                             "synchronous")
    parser.add_argument("--save_dir", default="trained_models")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.model in ("graphvit", "dilresnet"):
        raise NotImplementedError(f"--model {args.model} is not ported yet "
                                  "(ROADMAP Queue 1 item 11)")
    if args.dtype == "bf16":
        raise NotImplementedError("--dtype bf16 is not ported yet (ROADMAP Queue 1 item 11)")
    if args.horizon_eval is None:
        args.horizon_eval = 101
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")
    return run_graph_model(args)


if __name__ == "__main__":
    main()
