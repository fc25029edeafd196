"""The port's auto-resume watchdog (``tools/watchdog.py``) on the CPU.

- JAX's three scenarios (``tests/test_watchdog.py``: a crash after a
  checkpoint exists, a fresh start, the restart budget spent) on port
  checkpoints, with ``subprocess.run`` and ``time.sleep`` replaced: the
  port's supervisor and the JAX package's run side by side over the same
  folder, and the commands they launch are equal once the package name is
  swapped; ``device`` is forwarded as ``--device``.
- One real run: ``main`` on a 2-epoch copy of the slice tests' GPT-2 config
  cut to 2 layers (``synthetic:2``, a checkpoint each epoch), under a
  wrapper passed as ``supervise(python=...)`` that kills its first child
  (SIGKILL) as soon as the first checkpoint is on disk (``chip_smoke.py``'s
  ``WATCHDOG_WRAPPER``, which phase 25 runs on the card): exit code 0, one
  restart, the second launch ``continue_train`` from that step, and the run
  folder's newest checkpoint that of the last epoch.
"""

import logging
import os
import stat
import sys

import torch
import yaml

from fluid_llm_tpu.tools import watchdog as jwatchdog
from fluid_llm_tpu_torch.tools import watchdog
from fluid_llm_tpu_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_slice import CFG, SEQ_LEN  # noqa: E402
from test_torch_train import _tiny_trainer  # noqa: E402

torch.set_num_threads(2)


class FakeRun:
    """Records launched commands; scripted exit codes."""

    def __init__(self, rcs):
        self.rcs = list(rcs)
        self.cmds = []

    def __call__(self, cmd, env=None):
        self.cmds.append(cmd)

        class R:
            returncode = self.rcs.pop(0)

        return R()


def _both(monkeypatch, rcs, *args, **kw):
    """The port's and JAX's supervisors on the same arguments: their exit
    codes and launched commands (JAX's with the port's package name)."""
    out = []
    for mod in (watchdog, jwatchdog):
        fake = FakeRun(rcs)
        monkeypatch.setattr(mod.subprocess, "run", fake)
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        rc = mod.supervise(*args, **kw)
        out.append((rc, [[a.replace("fluid_llm_tpu.", "fluid_llm_tpu_torch.") for a in c]
                         for c in fake.cmds]))
    assert out[0] == out[1]
    return out[0]


def test_fresh_then_resume_after_crash(tmp_path, monkeypatch):
    """A crash after a checkpoint exists: relaunched through continue_train."""
    trainer, _ = _tiny_trainer(dropout=False)
    folder = ckpt.make_save_folder(str(tmp_path), None)
    ckpt.save_checkpoint(folder, 0, trainer.model, trainer.opt, 0, trainer.cfg)
    rc, cmds = _both(monkeypatch, [1, 0], "cfg.yaml", str(tmp_path), max_restarts=3,
                     backoff_s=0)
    assert rc == 0 and len(cmds) == 2
    assert all("fluid_llm_tpu_torch.continue_train" in " ".join(c) for c in cmds)


def test_fresh_start_without_checkpoint(tmp_path, monkeypatch):
    rc, cmds = _both(monkeypatch, [0], "cfg.yaml", str(tmp_path / "none"), max_restarts=1)
    assert rc == 0 and cmds[0][1:] == ["-m", "fluid_llm_tpu_torch.main", "--config_path",
                                       "cfg.yaml"]


def test_restart_budget_exhausted(tmp_path, monkeypatch):
    rc, cmds = _both(monkeypatch, [2, 2, 2], "cfg.yaml", str(tmp_path / "none"),
                     max_restarts=2, backoff_s=0)
    assert rc == 2 and len(cmds) == 3  # initial + 2 restarts


def test_device_forwarded(tmp_path, monkeypatch):
    fake = FakeRun([0])
    monkeypatch.setattr(watchdog.subprocess, "run", fake)
    assert watchdog.supervise("cfg.yaml", str(tmp_path / "none"), device="cuda") == 0
    assert fake.cmds[0][-2:] == ["--device", "cuda"]


def test_real_run_recovers_from_a_killed_child(tmp_path, caplog):
    runs, log = tmp_path / "runs", tmp_path / "launches.txt"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        CFG, llm_layers=2, load_dir="synthetic:2", num_epochs=2, save_model_each=1,
        val_seq_len=SEQ_LEN, checkpoint_save_path=str(runs))))
    wrapper = tmp_path / "python"
    wrapper.write_text(chip_smoke.WATCHDOG_WRAPPER.format(python=sys.executable, log=str(log),
                                                         runs=str(runs)))
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    env = {"HF_HUB_CACHE": str(tmp_path / "hub"), "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                          os.environ.get("PYTHONPATH", "")])}
    with caplog.at_level(logging.INFO, logger="fluid_llm_tpu_torch.watchdog"):
        rc = watchdog.supervise(str(cfg_path), str(runs), max_restarts=2, backoff_s=0,
                                extra_env=env, python=str(wrapper), device="cpu")
    lines = log.read_text().splitlines()
    assert rc == 0, lines
    assert lines[0] == f"-m fluid_llm_tpu_torch.main --config_path {cfg_path} --device cpu"
    assert lines[1] == "killed after step_0.epoch"
    assert lines[2] == f"-m fluid_llm_tpu_torch.continue_train --checkpoint_dir {runs} " \
                       "--device cpu"
    assert len(lines) == 3  # one restart
    assert any("Resuming from" in r.message and r.message.endswith("step_0")
               for r in caplog.records)
    run = ckpt.get_save_folder(str(runs), -1)
    assert os.listdir(runs) == ["000"] and ckpt.latest_step(run) == 1  # the last epoch's
    assert (tmp_path / "runs" / "000" / "step_1.epoch").read_text() == "1"
