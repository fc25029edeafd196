"""Faults planted under the timed path, to show that the comparison catches them.

Each is a context manager that patches the port while it is open:

- ``state_unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: the loss over the first half of the batch's rows only,
  its mean taken over them;
- ``answer_altered``: one rollout step's predicted frame shifted where the
  model produces it;
- ``frames_unchanged``: every rollout step predicts no change.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def state_unchanged():
    return patched(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch():
    from fluid_llm_tpu_torch.train.trainer import Trainer

    original = Trainer.mode_loss

    def mode_loss(self, batch, mode):
        return original(self, tuple(t[:max(1, t.shape[0] // 2)] for t in batch), mode)

    return patched(Trainer, "mode_loss", mode_loss)


def answer_altered(at_step: int = 2, shift: float = 0.05):
    """Every rollout's step ``at_step`` (0-based; its window holds
    ``at_step + 1`` valid frames) predicts a frame ``shift`` off."""
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    original = FluidLLM.predict_frame_diff

    def predict(self, states, position_ids, frame_valid, *args, **kwargs):
        out = original(self, states, position_ids, frame_valid, *args, **kwargs)
        return out + shift if int(frame_valid[0].sum()) == at_step + 1 else out

    return patched(FluidLLM, "predict_frame_diff", predict)


def frames_unchanged():
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    original = FluidLLM.predict_frame_diff
    return patched(FluidLLM, "predict_frame_diff",
                   lambda self, *a, **k: torch.zeros_like(original(self, *a, **k)))


FAULTS = {"train": {"state_unchanged": state_unchanged, "half_batch": half_batch},
          "rollout": {"answer_altered": answer_altered, "frames_unchanged": frames_unchanged}}
