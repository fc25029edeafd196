"""Starting the processes of a multi-process run.

The counterpart of ``jax.distributed.initialize`` in
``fluid_llm_tpu/main.py:136-170``, for ``main``, ``continue_train`` and
``inference``:

- ``--distributed`` with ``--coordinator_address HOST:PORT``,
  ``--num_processes`` and ``--process_id`` (all three together) starts
  ``torch.distributed`` over ``tcp://HOST:PORT``;
- ``--distributed`` alone reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), the
  counterpart of JAX's auto-detection on pods;
- the backend is nccl on ``--device cuda``, one rank a card
  (``cuda:LOCAL_RANK``), and gloo on ``--device cpu``.  Ranks that share
  a card (nccl refuses two ranks on one device) start gloo themselves
  (:func:`start`; ``chip_smoke.py`` phase 23): their collectives are
  staged through host memory (``parallel/comm.py``).

Without ``--distributed`` nothing starts a process group and every entry
point runs as one process.  With it, the entry points build the mesh of
the config's ``parallel`` keys over the ranks (``parallel/mesh.make_mesh``).
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from fluid_llm_tpu_torch.utils import get_device

logger = logging.getLogger("fluid_llm_tpu_torch.launch")

TIMEOUT = datetime.timedelta(minutes=10)


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--distributed", action="store_true",
                        help="start torch.distributed (torchrun's environment, or the three "
                             "flags below) and run over the mesh of the config's parallel keys")
    parser.add_argument("--coordinator_address", default=None,
                        help="HOST:PORT of rank 0 (or an init_method URL, e.g. file:///path)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def init(args: argparse.Namespace, parser: argparse.ArgumentParser) -> torch.device:
    """Start the process group ``args`` ask for and return this rank's
    device (``get_device(args.device)`` without ``--distributed``)."""
    flags = (args.coordinator_address, args.num_processes, args.process_id)
    if not args.distributed:
        if any(f is not None for f in flags):
            parser.error("--coordinator_address, --num_processes and --process_id need "
                         "--distributed")
        return get_device(args.device)
    if any(f is not None for f in flags):
        if any(f is None for f in flags):
            parser.error("--coordinator_address requires --num_processes and --process_id "
                         "(all three together; omit all three under torchrun)")
        addr = args.coordinator_address  # HOST:PORT, or an init_method URL (file://...)
        init_method = addr if "://" in addr else f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            parser.error(f"--distributed without the three flags reads torchrun's environment; "
                         f"{', '.join(missing)} not set")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", 0))
    device = get_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    start("nccl" if device.type == "cuda" else "gloo", init_method, world, rank, device)
    return device


def start(backend: str, init_method: str, world: int, rank: int,
          device: Optional[torch.device] = None, timeout: datetime.timedelta = TIMEOUT) -> None:
    """``init_process_group`` and one barrier, which proves the group; rank
    0 logs at INFO, the others at WARNING."""
    kw = {"device_id": device} if backend == "nccl" and device is not None else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout, **kw)
    dist.barrier()
    if rank != 0:
        logging.getLogger("fluid_llm_tpu_torch").setLevel(logging.WARNING)
    logger.info("torch.distributed: rank %d of %d over %s (%s)", rank, world, backend,
                init_method)


def is_lead() -> bool:
    """Rank 0, or no process group: the process that logs and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def share(obj):
    """Rank 0's ``obj`` on every rank (a run folder's path)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def finish() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
