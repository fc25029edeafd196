"""The port's configuration against the JAX package's, and the port's
independence of the JAX package: every shipped YAML parses to the same
values in both, the same inputs are refused with the same messages, and
neither ``fluid_llm_tpu_torch`` nor ``chip_smoke.py`` imports ``jax`` or
anything of ``fluid_llm_tpu`` (the card's machine has no jax)."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from fluid_llm_tpu import config as jconfig
from fluid_llm_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
CLASSES = ["Config", "LoraConfig", "PosEmbeddingConfig", "EncoderConfig", "DecoderConfig",
           "TeacherForcingConfig", "ParallelConfig", "MoEConfig"]
FOREIGN = ("jax", "jaxlib", "fluid_llm_tpu")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_parses_to_the_same_values(path):
    assert tconfig.Config.from_yaml(path).to_dict() == jconfig.Config.from_yaml(path).to_dict()


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_jax(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("raw", [
    {"no_such_key": 1},
    {"decoder_params": {"no_such_key": 1}},
    {"absolute_time_ids": True},
    {"optimizer": "lamb"},
    {"loss_function": ["mse", "huber"], "loss_weighting": [1.0, 1.0]},
    {"loss_function": ["mse"]},
    {"patch_size": [16, 16], "stride": [8, 8]},
    {"pos_embedding_params": {"pos_embedding_type": "alibi"}},
], ids=str)
def test_rejects_what_jax_rejects(raw):
    with pytest.raises(ValueError) as want:
        jconfig.Config.from_dict(raw)
    with pytest.raises(ValueError) as got:
        tconfig.Config.from_dict(raw)
    assert str(got.value) == str(want.value)


def _imported_modules(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_sources_import_nothing_of_jax():
    """Every import statement, also those inside functions (chip_smoke's
    phases import lazily)."""
    paths = glob.glob(os.path.join(ROOT, "fluid_llm_tpu_torch", "**", "*.py"), recursive=True)
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = {os.path.relpath(p, ROOT): sorted(m for m in _imported_modules(p)
                                            if m.split(".")[0] in FOREIGN)
           for p in paths}
    assert {p: m for p, m in bad.items() if m} == {}


def test_importing_the_port_loads_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import fluid_llm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'fluid_llm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"print(sorted(m for m in set(sys.modules) - before if m.split('.')[0] in {FOREIGN!r}))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
