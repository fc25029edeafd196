"""The reference against the port at a tiny size on the CPU: sound runs are
correct; the control (float8 products, bfloat16 data) and each fault that a
cell can have are not.  The card's look is skipped; the rest of a run is
driven as it is on the card."""

import torch
import pytest

from portbench.lib import faults, spec
from portbench.reference import check
from portbench.tests import tiny

CELLS = ["tiny_pre.train", "tiny_post.train", "tiny_pre.rollout", "tiny_post.rollout"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(root, cell):
    code, result = tiny.run(root, cell, 4_100_000_007, seconds=0.3)
    assert code == 0 and result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "train_samples_per_s" if "train" in cell
                                      else "rollout_frames_per_s"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", ["tiny_pre.train", "tiny_pre.rollout"])
def test_traced_run_reports_per_layer_metrics(root, cell):
    code, result = tiny.run(root, cell, 4_100_000_011, seconds=0.2, trace=1)
    assert code == 0 and result["correct"]
    # on the CPU no device metric is read; the host's are
    assert "setup_s" not in result["metrics"]
    assert all("roofline" not in k and "idle" not in k and "mfu" not in k
               for k in result["metrics"])
    # the data layer's batches are built in set-up and read on the host's clock
    kind = "train" if "train" in cell else "rollout"
    assert result["metrics"][f"batch_build_ms.{kind}"]["value"] > 0
    assert result["device"]["window_s"] > 0 and "breakdown" in result


FAULTS = [(c, f) for c in ("tiny_pre.train", "tiny_post.train") for f in faults.FAULTS["train"]] \
    + [(c, f) for c in ("tiny_pre.rollout", "tiny_post.rollout") for f in faults.FAULTS["rollout"]]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    with faults.FAULTS[spec.load_cell(root, cell).traffic["kind"]][fault]():
        code, result = tiny.run(root, cell, 4_100_000_013, seconds=0.3)
    assert code == 0 and not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", ["tiny_pre.train", "tiny_post.rollout"])
def test_the_control_is_not_correct(root, cell):
    """The reference in the precision below the configuration's, in the
    program's place, fails the cell's limits; the program passes them."""
    from portbench import calibrate

    c = spec.load_cell(root, cell)
    run = c.driver.Run(c, 4_100_000_017, torch.device("cpu"), lambda m: None)
    run.setup()
    run.window(0.2)
    run.finish()
    if c.traffic["kind"] == "train":
        ref = run.reference()
        program, control = check.train_numbers(run.prog, ref), \
            check.train_numbers(run.reference(control=True), ref)
    else:
        program, control = run.check(), calibrate.control_rollout(run, torch.device("cpu"))
    limits = c.limits["limits"]
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control


def test_the_training_window_steps_on_the_batches_built_in_setup(root):
    """Set-up builds the feed's first ``pool_batches`` batches; its checked
    steps take the first of them (rows all different), and the window steps
    through the same batches again and again."""
    c = spec.load_cell(root, "tiny_pre.train")
    run = c.driver.Run(c, 4_100_000_019, torch.device("cpu"), lambda m: None)
    run.setup()
    assert run.build["batches"] == len(run.pool) == c.traffic["pool_batches"]
    checked = [row for rows in run.check_rows for row in rows]
    assert len(checked) == sum(b[0].shape[0] for b in run.pool[:c.traffic["check_steps"]])
    assert len(set(map(repr, checked))) == len(checked)
    stepped = []
    step = run.trainer.train_step
    run.trainer.train_step = lambda batch, mode: (stepped.append(batch), step(batch, mode))[1]
    run.window(0.2)
    pool = {id(b): k for k, b in enumerate(run.pool)}
    order = [pool[id(b)] for b in stepped]
    n = len(run.pool)
    assert order == [(c.traffic["check_steps"] + i) % n for i in range(len(order))]
    run.finish()
