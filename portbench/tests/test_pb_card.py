"""The harness on the card, at a tiny size with head and grid widths the
kernels take: a run is correct, the traced run reads the device metrics.

Marked ``cuda``: skips where there is no card (decided in the fixture)."""

import pytest
import torch

from portbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return tiny.make_root(tmp_path_factory.mktemp("card"), card=True)


@pytest.mark.parametrize("cell", ["tiny_pre.train", "tiny_post.rollout"])
def test_traced_run_on_the_card(card_root, cell):
    code, result = tiny.run(card_root, cell, 4_200_000_001, seconds=1.0, trace=1,
                            device=torch.device("cuda"))
    assert code == 0 and result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    kind = cell.split(".")[1]
    for name in (f"device_idle.{kind}", f"slot_roofline.{kind}", f"attn_roofline.{kind}"):
        assert 0.0 < result["metrics"][name]["value"] <= 105.0, name
