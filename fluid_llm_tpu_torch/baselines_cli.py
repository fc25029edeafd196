"""Train / eval CLI for the EAGLE-benchmark baselines (MeshGraphNet, GAT,
GraphViT, DilResNet).

Counterpart of ``fluid_llm_tpu/baselines_cli.py``
(``eagle/train_{mgn,gat,graphvit,DilResNet}.py``,
``eagle/eval_{mgn,graphvit,DRN}.py``):

    python -m fluid_llm_tpu_torch.baselines_cli --model mgn --dataset_path synthetic \\
        --mesh_nodes 84x42 --epoch 500 [--device cuda] [...]

Protocol as the JAX CLI: Adam (betas 0.9/0.999, eps 1e-8, no weight decay;
``optax.scale_by_adam`` with the lr applied outside) and ExponentialLR
(0.991) stepped after every epoch past the second (``train_mgn.py:124-127,
139-140``, the JAX CLI's ``epoch > 1``); masked MSE on normalised diffs;
fixed val/test windows; rollout eval over ``--horizon_eval`` frames (101,
GraphViT 51) scored by mesh -> grid N-RMSE (``eagle_utils.py:89-130``) with
the per-step CSV.  GraphViT has no normalizer, takes ghost type 2 and the
collate's cluster tables (its file datasets normalised, with
``constrained_kmeans_{n}`` tables); DilResNet trains on grid windows
(``data/grid_images``) and is scored by ``train/metrics.calc_n_rmse``,
with the probes at steps 5/20/40/100.

``--dtype bf16`` (graph models) runs the network in bf16 over f32 master
weights (the JAX CLI's ``_cast_fn``): each call takes the f32 parameters
cast to bf16 through ``torch.func.functional_call``, so the gradients flow
back to the masters; Adam's state, the normalizers, the loss and the
rollout state stay f32.  Nodes are relabeled cluster-major under bf16 and
in RCM order under f32, as the JAX CLI (``_order_mode``).  Checkpoints are
``<save_dir>/<model>/<name>.pt`` (``{params, norm}``); ``--epoch 0`` loads
one and only evaluates.  ``main`` returns a summary of the run.
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
from fluid_llm_tpu_torch.data.grid_images import GridImageDataset, iterate_image_batches
from fluid_llm_tpu_torch.data.reorder import reorder_sample
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset, SyntheticGraphDataset
from fluid_llm_tpu_torch.models.baselines.base import load_norm
from fluid_llm_tpu_torch.models.baselines.dilresnet import DilResNet, dilresnet_loss
from fluid_llm_tpu_torch.models.baselines.gat import GAT
from fluid_llm_tpu_torch.models.baselines.graphvit import GraphViT, graphvit_loss
from fluid_llm_tpu_torch.models.baselines.mgn import MGN, mgn_loss
from fluid_llm_tpu_torch.train.eagle_eval import get_nrmse
from fluid_llm_tpu_torch.train.loop import _profiler
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse
from fluid_llm_tpu_torch.utils import get_device, set_seed

logger = logging.getLogger("fluid_llm_tpu_torch.baselines")

PROBES = (5, 20, 40, 100)  # DilResNet's per-step N-RMSE probes


def order_mode(args) -> str:
    """The JAX CLI's node order (``_order_mode``, ``baselines_cli.py:
    180-185``): cluster-major under bf16, RCM under f32."""
    return "cluster" if args.dtype == "bf16" else "rcm"


def ghost_type(args) -> int:
    """Ghost nodes' one-hot value: 1 for MGN and GAT (INPUT + WALL: forced),
    2 for GraphViT (``baselines_cli.py:259``)."""
    return 2 if args.model == "graphvit" else 1


def build_dataset(args, mode: str, window: int):
    if args.model == "dilresnet":
        if args.dataset_path == "synthetic":
            kw = {"max_steps": args.max_steps} if args.max_steps else {}
            src = SyntheticCylinderDataset(n_trajectories=args.n_traj,
                                           resolution=args.resolution, mode=mode, **kw)
        else:
            from fluid_llm_tpu_torch.data.cylinder import MGNDataset

            src = MGNDataset(f"{args.dataset_path}/{mode}", resolution=args.resolution,
                             mode=mode)
        return GridImageDataset(src, window_length=window, mode=mode)
    vit = args.model == "graphvit"
    if args.dataset_path == "synthetic":
        kw = {}
        if args.mesh_nodes:
            kw["mesh_nodes"] = tuple(int(v) for v in args.mesh_nodes.lower().split("x"))
        if args.max_steps:
            kw["max_steps"] = args.max_steps
        return SyntheticGraphDataset(n_trajectories=args.n_traj, mode=mode,
                                     window_length=window,
                                     n_cluster=args.n_cluster if vit else 0, **kw)
    kw = dict(mode=mode, window_length=window, normalize=vit, with_cluster=vit,
              n_cluster=args.n_cluster)
    if "eagle" in args.dataset_path.lower():
        return EagleDroneDataset(args.dataset_path, **kw)
    if "airfoil" in args.dataset_path.lower():
        return AirfoilGraphDataset(args.dataset_path, **kw)
    return EagleMGNDataset(args.dataset_path, **kw)


def build_model(args, device: torch.device):
    """The model drawn from seed 1 (the JAX CLI's ``PRNGKey(1)``; the two
    frameworks' streams differ) and its initial normalizer state (empty for
    GraphViT and DilResNet)."""
    g = torch.Generator().manual_seed(1)
    if args.model == "mgn":
        model = MGN(4, args.n_processor, generator=g)
    elif args.model == "gat":
        model = GAT(4, args.n_processor, args.n_heads, generator=g)
    elif args.model == "graphvit":
        model = GraphViT(4, args.w_size, generator=g)
    else:
        model = DilResNet(channels=3, generator=g)
    model.to(device)
    return model, model.init_norm(device) if isinstance(model, MGN) else {}


def make_optimizer(model, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def to_device(batch: dict, device: torch.device) -> dict:
    """Host batch -> tensors on ``device`` (from pinned memory on CUDA).
    ``collate_graphs`` writes one edge list for every step of a window: it
    is sent once and broadcast over the time axis, so the model builds one
    segment index per edge column for the window (and GraphViT one of the
    cluster members where the table does not change)."""
    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    out = {}
    for k, v in batch.items():
        # the window's one edge list, and a cluster table the same at every
        # step, are sent once and broadcast over the time axis
        once = k == "edges" or (k in ("cluster", "cluster_mask") and bool((v == v[:, :1]).all()))
        out[k] = put(v[:, :1]).expand(v.shape) if once else put(v)
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


def compute_dtype_call(args, model, inputs: tuple, kwargs: dict):
    """``model(*inputs, **kwargs)``; under ``--dtype bf16`` with every f32
    parameter cast to bf16 for the call (``_cast_fn``), the gradient flowing
    back to the f32 masters through the cast."""
    if args.dtype != "bf16":
        return model(*inputs, **kwargs)
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
              for n, p in model.named_parameters()}
    return torch.func.functional_call(model, params, inputs, kwargs)


def apply_model(args, model, norm, batch, *, train: bool, generator=None):
    """(state_hat, output_hat, target, new norm) of the batch's window; the
    input noise only in training."""
    graph = (batch["mesh_pos"], batch["edges"], batch["state"], batch["node_type"])
    noise = dict(apply_noise=train and args.noise_std > 0, noise_std=args.noise_std,
                 generator=generator)
    if args.model == "graphvit":
        out = compute_dtype_call(args, model, graph + (batch["cluster"], batch["cluster_mask"]),
                                 noise)
        return (*out, norm)
    return compute_dtype_call(args, model, (norm,) + graph, dict(noise, train=train))


def graph_loss(args, output_hat, target, mask) -> torch.Tensor:
    """The model's masked loss (``train_mgn.py:64-72``, ``train_graphvit.py:79-88``)."""
    if args.model == "graphvit":
        return graphvit_loss(output_hat, target, mask, alpha=args.alpha)
    return mgn_loss(output_hat, target, mask, w_pressure=args.w_pressure)


def train_step(args, model, norm, opt, batch, lr: float, generator):
    """One step (``make_graph_step``): loss and gradient of the window
    rollout with noise, Adam at ``lr``.  Returns (new norm, loss tensor)."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    _, output_hat, target, new_norm = apply_model(args, model, norm, batch, train=True,
                                                  generator=generator)
    loss = graph_loss(args, output_hat, target, batch["mask"])
    loss.backward()
    opt.step()
    return new_norm, loss.detach()


@torch.no_grad()
def validate_graph(args, model, norm, ds, device) -> float:
    """Mean over samples of the batch losses on ``ds`` (normalizers frozen)."""
    tot, cpt = 0.0, 0
    for b in prefetch(iterate_graph_batches(ds, args.batch_size, shuffle=False,
                                            ghost_type_value=ghost_type(args),
                                            reorder=order_mode(args)),
                      device, args.prefetch):
        _, output_hat, target, _ = apply_model(args, model, norm, b, train=False)
        tot += float(graph_loss(args, output_hat, target, b["mask"]))
        cpt += b["mesh_pos"].shape[0]
    return tot / max(cpt, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def eval_graph(args, model, norm, device) -> dict:
    """Rollout over the ``--horizon_eval`` window of every test trajectory,
    mesh -> grid N-RMSE per step, and the per-step CSV (``eval_mgn.py:29-68``,
    ``eval_graphvit.py:77-149``)."""
    ds = build_dataset(args, "test", args.horizon_eval)
    rows, rollout_s, steps = [], 0.0, 0
    for i in range(len(ds)):
        sample = reorder_sample(ds[i], order_mode(args))
        n_cluster = sample.cluster.shape[1] if sample.cluster is not None else 1
        batch = to_device(collate_graphs([sample], sample.mesh_pos.shape[1],
                                         sample.edges.shape[0], n_cluster, ghost_type(args)),
                          device)
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
    return dict(n_rmse=per_step, csv=write_csv(args, per_step), n_test=len(ds),
                eval_steps=steps, eval_s=rollout_s)


def write_csv(args, per_step: np.ndarray) -> str:
    """The per-step N-RMSE as ``<save_dir>/<model>/<name>_nrmse.csv``."""
    csv_path = os.path.join(args.save_dir, args.model, f"{args.name}_nrmse.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "n_rmse"])
        for s, v in enumerate(per_step):
            w.writerow([s, float(v)])
    logger.info("wrote %s", csv_path)
    return csv_path


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
                                                    seed=epoch, ghost_type_value=ghost_type(args),
                                                    reorder=order_mode(args)),
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


def run_dilresnet(args) -> dict:
    """``run_dilresnet`` (``baselines_cli.py:392-450``): Adam and
    ExponentialLR as the graph models on grid windows, then the rollout of
    every test window (batch 1) scored by ``calc_n_rmse`` per step, the CSV
    and the probes at steps 5/20/40/100 (``eval_DRN.py:43-88``)."""
    device = get_device(args.device)
    set_seed(1)
    train_ds = build_dataset(args, "train", args.horizon_train)
    model, _ = build_model(args, device)
    opt = make_optimizer(model, args.lr)
    noise = torch.Generator(device=device).manual_seed(1)
    os.makedirs(os.path.join(args.save_dir, args.model), exist_ok=True)
    ckpt = checkpoint_path(args)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lr = args.lr
    summary = dict(train_steps=0, train_loss=[], epoch_s=[])
    for epoch in range(args.epoch):
        t_ep, n_steps = time.perf_counter(), 0
        for state, mask in iterate_image_batches(train_ds, args.batch_size, shuffle=True,
                                                 seed=epoch):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.zero_grad(set_to_none=True)
            _, delta, target = model(put(state), put(mask), apply_noise=args.noise_std > 0,
                                     noise_std=args.noise_std, generator=noise)
            loss = dilresnet_loss(delta, target)
            loss.backward()
            opt.step()
            loss = loss.detach()
            n_steps += 1
        dt = time.perf_counter() - t_ep
        if epoch > 1:
            lr *= 0.991
        logger.info("=== EPOCH %d === loss=%.4g (%d steps, %.2fs)", epoch + 1, float(loss),
                    n_steps, dt)
        save_params(ckpt, model, {})
        summary["train_steps"] += n_steps
        summary["train_loss"].append(float(loss))
        summary["epoch_s"].append(dt)
    if args.epoch == 0:
        load_params(ckpt, model, {})

    test_ds = build_dataset(args, "test", args.horizon_eval)
    rows, rollout_s, steps = [], 0.0, 0
    with torch.no_grad():
        for state, mask in iterate_image_batches(test_ds, 1, shuffle=False):
            state, mask = put(state), put(mask)
            _sync(device)
            t0 = time.perf_counter()
            state_hat = model(state, mask)[0]
            _sync(device)
            rollout_s += time.perf_counter() - t0
            steps += state_hat.shape[1] - 1
            true = state.permute(0, 1, 4, 2, 3)
            m = mask[:, :, None].expand(true.shape)
            rows.append(calc_n_rmse(state_hat.permute(0, 1, 4, 2, 3), true, m)[0].cpu().numpy())
    per_step = np.stack(rows).mean(axis=0)
    probes = {s: float(per_step[s]) for s in PROBES if s < len(per_step)}
    logger.info("DilResNet overall N-RMSE: %.4g (per-step probes %s; %d rollout steps in "
                "%.2f s)", float(per_step.mean()), {k: f"{v:.3g}" for k, v in probes.items()},
                steps, rollout_s)
    summary.update(n_rmse=per_step, probes=probes, csv=write_csv(args, per_step),
                   n_test=len(test_ds), eval_steps=steps, eval_s=rollout_s, checkpoint=ckpt)
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
    # reference eval horizons: MGN/DRN 101-step windows (``eval_mgn.py:29``,
    # ``eval_DRN.py:43``), GraphViT 51 (``eval_graphvit.py:77``)
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
                        help="compute dtype of the graph models: bf16 runs the network in "
                             "bfloat16 over f32 master weights (normalizers, loss and "
                             "rollout state stay f32); DilResNet runs in f32")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches built and copied ahead on a worker thread; 0 = "
                             "synchronous")
    parser.add_argument("--save_dir", default="trained_models")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.horizon_eval is None:
        args.horizon_eval = 51 if args.model == "graphvit" else 101
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")
    return run_dilresnet(args) if args.model == "dilresnet" else run_graph_model(args)


if __name__ == "__main__":
    main()
