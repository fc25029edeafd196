"""What the per-layer readers share: the rooflines of the attention and of the
grid slot attention, summed over the traced sub-window's calls.

A roofline share is the least time the card could take for the work (its
bytes and operations from shapes, ``lib/counts.py``; the bound of
``lib/peaks.py``, call by call) over the device time of the kernels that
did it (by name, from the trace).  Where the trace holds no such kernel
the share is not read (None), never 0.
"""

from __future__ import annotations

from portbench.lib import counts, peaks


def share(bound_s: float, kernel_s: float):
    return None if kernel_s <= 0.0 else 100.0 * bound_s / kernel_s


def bound(work) -> float:
    return peaks.bound_s(*work)


def attn_train_bound(run, steps: int) -> float:
    """The attention of every block of ``steps`` training steps: forward
    (with its lse) and backward, every token valid."""
    d, B = run.dims, run.batch_size
    n = run.frames * d.n_patch + 1
    per = bound(counts.attention_fwd_work(d, B, n, lse=True)) \
        + bound(counts.attention_bwd_work(d, B, n))
    return steps * d.n_layers * per


def attn_rollout_bound(run, rollouts: int) -> float:
    """The full-window attention of every block but the last (which
    attends from the newest frame only) over each step of the rollouts."""
    d, B = run.dims, run.batch_size
    total = 0.0
    for i in range(run.steps):
        _, n = counts.window_tokens(d, i, run.window_frames)
        total += (d.n_layers - 1) * bound(counts.attention_fwd_work(d, B, n, lse=False))
    return rollouts * total


def slot_bound(run, frames: int, backward: bool) -> float:
    """The decoder's slot attention over ``frames`` frames, each conv once,
    forward and, with ``backward``, its backward."""
    d = run.dims
    total = 0.0
    for c in counts.slot_channels(d):
        total += bound(counts.slot_fwd_work(frames, d.frame_pixels, c, counts.BF16))
        if backward:
            total += bound(counts.slot_bwd_work(frames, d.frame_pixels, c, counts.BF16))
    return total
