"""Inputs and weights come from the seed: the same seed gives the same, another differs."""

import json
from pathlib import Path

import numpy as np
import torch

from portbench.inputs import cylinder, weights
from portbench.reference import data as rd

BENCH = Path(__file__).resolve().parent.parent
BIG = 3_987_654_321  # over 32 signed bits, as the driver's seeds may be


def test_trajectories_repeat_in_the_seed_and_differ_across():
    a = cylinder.trajectory(BIG, "train", 3, (40, 16), 20)
    b = cylinder.trajectory(BIG, "train", 3, (40, 16), 20)
    c = cylinder.trajectory(BIG + 1, "train", 3, (40, 16), 20)
    d = cylinder.trajectory(BIG, "test", 3, (40, 16), 20)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[2], c[2])
    assert not np.array_equal(a[2], d[2])


def test_every_trajectory_has_the_same_grid():
    conf = json.loads((BENCH / "configs" / "opt125m.json").read_text())
    shapes, masks = set(), []
    for idx in range(4):
        pos, faces, _ = cylinder.trajectory(BIG, "train", idx, (40, 16), 2)
        gx, _ = rd.grid(pos, conf["fluid_llm"]["resolution"])
        shapes.add(gx.shape)
        tri, _ = rd.locate(pos, faces, *rd.grid(pos, conf["fluid_llm"]["resolution"]))
        masks.append(tri < 0)
    assert shapes == {(238, 60)}
    # the obstacle moves: the masks differ
    assert not np.array_equal(masks[0], masks[1])


def test_weights_repeat_in_the_seed_and_match_the_spec():
    conf = json.loads((BENCH / "configs" / "opt350m.json").read_text())
    conf["backbone"]["num_hidden_layers"] = 1  # the names of one layer suffice here
    dev = torch.device("cpu")
    a, b = weights.make(conf, BIG, dev), weights.make(conf, BIG, dev)
    c = weights.make(conf, BIG + 1, dev)
    spec = weights.spec(conf)
    assert list(a) == [n for n, *_ in spec]
    for name, shape, *_ in spec:
        assert a[name].shape == shape and a[name].dtype == torch.float32
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["backbone.layers.0.attn.q.weight"], c["backbone.layers.0.attn.q.weight"])
    # post-LN OPT-350m: project_in/out at 512, no final norm
    assert a["backbone.project_in.weight"].shape == (1024, 512)
    assert "backbone.final_norm.weight" not in a
    # LoRA's B is away from zero, DoRA's m from the plain column norm
    assert a["lora.layers.0.attn.v.B"].abs().sum() > 0
    w = a["backbone.layers.0.attn.v.weight"]
    assert not torch.allclose(a["lora.layers.0.attn.v.m"], w.norm(dim=1))
