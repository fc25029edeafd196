"""Auto-resume training supervisor.

Counterpart of ``fluid_llm_tpu/tools/watchdog.py``.  The reference has no
failure handling: a crash loses the run.  This wraps the port's training
entry points in a supervise-and-resume loop over its checkpoints
(``train/checkpoint.py``):

    python -m fluid_llm_tpu_torch.tools.watchdog --config_path configs/training1.yaml \\
        [--device cuda]

- the first attempt runs ``python -m fluid_llm_tpu_torch.main`` (fresh
  training);
- on a non-zero exit it relaunches ``python -m
  fluid_llm_tpu_torch.continue_train`` from the newest checkpoint of the
  newest run folder, repeatedly, with exponential backoff, until the run
  completes or ``--max_restarts`` is spent;
- while no checkpoint was ever written the fresh entry point is retried;
- a failure before any new checkpoint counts against the budget all the
  same, so a deterministic fault cannot spin forever.

The children run the entry points unmodified (``--device`` forwarded); the
watchdog owns no training state.  Under ``--distributed`` the supervisor
is torchrun's: ``torchrun --max-restarts N -m fluid_llm_tpu_torch.main``.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import time

logger = logging.getLogger("fluid_llm_tpu_torch.watchdog")


def _latest_run_state(checkpoint_dir: str):
    """(run folder, newest step) or (None, None) if nothing usable exists."""
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    try:
        folder = ckpt.get_save_folder(checkpoint_dir, -1)
        step = ckpt.latest_step(folder)
    except (FileNotFoundError, ValueError, OSError):
        return None, None
    return (folder, step) if step is not None else (None, None)


def supervise(
    config_path: str,
    checkpoint_dir: str,
    max_restarts: int = 5,
    backoff_s: float = 10.0,
    extra_env: dict | None = None,
    python: str = sys.executable,
    device: str | None = None,
) -> int:
    """Run training under supervision; returns the final exit code.
    ``python``: the interpreter the children run under; ``device``:
    forwarded as ``--device`` (None: the entry points' default)."""
    env = dict(os.environ, **(extra_env or {}))
    dev = [] if device is None else ["--device", device]
    restarts = 0
    while True:
        folder, step = _latest_run_state(checkpoint_dir)
        if folder is None:
            cmd = [python, "-m", "fluid_llm_tpu_torch.main", "--config_path", config_path, *dev]
        else:
            cmd = [python, "-m", "fluid_llm_tpu_torch.continue_train",
                   "--checkpoint_dir", checkpoint_dir, *dev]
            logger.info("Resuming from %s step_%s", folder, step)
        logger.info("Launching (attempt %d): %s", restarts + 1, " ".join(cmd))
        rc = subprocess.run(cmd, env=env).returncode
        if rc == 0:
            logger.info("Training completed cleanly")
            return 0
        restarts += 1
        if restarts > max_restarts:
            logger.error("Exit code %d; restart budget (%d) exhausted", rc, max_restarts)
            return rc
        delay = backoff_s * (2 ** (restarts - 1))
        logger.warning("Exit code %d; restart %d/%d in %.0fs", rc, restarts, max_restarts, delay)
        time.sleep(delay)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config_path", default="configs/training1.yaml")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="defaults to the config's checkpoint_save_path")
    parser.add_argument("--max_restarts", type=int, default=5)
    parser.add_argument("--backoff_s", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")

    checkpoint_dir = args.checkpoint_dir
    if checkpoint_dir is None:
        from fluid_llm_tpu_torch.config import Config

        checkpoint_dir = Config.from_yaml(args.config_path).checkpoint_save_path
    sys.exit(supervise(args.config_path, checkpoint_dir, max_restarts=args.max_restarts,
                       backoff_s=args.backoff_s, device=args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
