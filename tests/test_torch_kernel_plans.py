"""The launch plans of the split-KV slab decode and the split-K indexed linear.

Both are plain Python functions of the shapes (``ops/decode_attention.
split_plan``, ``ops/indexed_linear.plan``), so they are held here, on the
CPU: every key tile lies in exactly one split and no split is empty; the K
split covers K in whole 64-deep steps with a cluster the kernel accepts;
the streaming step's decode fills a wave of the H100's 132 SMs and its
linears run at most one block an SM, unsplit where the K run fits the
kernel's ring; every shape ``supported`` accepts gets a plan.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.ops import indexed_linear as il

torch.set_num_threads(2)

# the flagship's streaming step (fluid/llama-125m, 12 heads; 10 ring frames
# of 60 tokens + 61 sinks: 11 slots of 64 keys): decode, first decode and
# prefill have one query tile at bs 1
FLAGSHIP_KEYS, FLAGSHIP_HEADS = 11 * 64, 12


@pytest.mark.parametrize("n_keys,heads,q_tiles,bs", [
    (64, 12, 1, 1), (128, 12, 1, 1), (11 * 64, 12, 1, 1), (33 * 64, 12, 1, 1),
    (11 * 64, 12, 1, 2), (11 * 64, 12, 1, 4), (11 * 64, 12, 2, 1), (11 * 64, 4, 2, 2),
    (61, 1, 1, 1), (700, 3, 1, 1), (5000 * 64, 1, 1, 1), (11 * 64, 200, 1, 1),
])
def test_split_plan_puts_every_key_tile_in_one_nonempty_split(n_keys, heads, q_tiles, bs):
    n_splits, split_keys = da.split_plan(n_keys, heads, q_tiles, bs)
    n_tiles = -(-n_keys // da.KEY_TILE)
    assert 1 <= n_splits <= da.MAX_SPLITS and split_keys % da.KEY_TILE == 0
    runs = [range(s * split_keys // da.KEY_TILE, min(n_tiles, (s + 1) * split_keys // da.KEY_TILE))
            for s in range(n_splits)]
    assert all(len(run) > 0 for run in runs)  # no empty split
    assert sorted(t for run in runs for t in run) == list(range(n_tiles))  # each tile once
    # the kernel's own check on the plan
    assert n_splits * split_keys >= n_keys > (n_splits - 1) * split_keys


@pytest.mark.parametrize("P", [60, 61])  # decode (and first decode), prefill
def test_split_plan_fills_a_wave_at_the_flagship_decode(P):
    n_splits, split_keys = da.split_plan(FLAGSHIP_KEYS, FLAGSHIP_HEADS, -(-P // da.QUERY_TILE), 1)
    assert n_splits * FLAGSHIP_HEADS >= 132
    assert (n_splits, split_keys) == (11, 64)  # one 64-key tile a split, 132 blocks


@pytest.mark.parametrize("bs,sms", [(1, 132), (2, 132), (4, 132), (1, 114), (8, 132)])
def test_split_plan_takes_the_fewest_splits_that_fill_a_wave(bs, sms):
    """More batch rows need fewer splits: the plan stops at the first split
    count whose grid reaches ``sms`` blocks; a wave that needs more splits
    than there are tiles gets one tile a split."""
    n_tiles = FLAGSHIP_KEYS // da.KEY_TILE
    base = FLAGSHIP_HEADS * bs
    n_splits, split_keys = da.split_plan(FLAGSHIP_KEYS, FLAGSHIP_HEADS, 1, bs, sms)
    if n_tiles * base < sms:
        assert split_keys == da.KEY_TILE
    else:
        assert n_splits * base >= sms
        per = split_keys // da.KEY_TILE
        if per < n_tiles:  # one more tile a split would leave the wave short
            assert -(-n_tiles // (per + 1)) * base < sms


# (M, K, N) of the stacked streaming step (fluid/llama-125m, q/k/v packed):
# qkv, o, gate and up, down at the decode's 60 rows and the prefill's 61
STREAMING_LINEARS = [(M, K, N) for M in (60, 61)
                     for K, N in ((768, 2304), (768, 768), (768, 2048), (2048, 768))]


@pytest.mark.parametrize("M,K,N", STREAMING_LINEARS)
def test_indexed_plan_runs_at_most_one_block_an_sm_at_the_streaming_linears(M, K, N):
    """At most 132 blocks (a block takes most of an SM's shared memory, so
    an SM given two runs them one after the other), and at least 48: the
    16-column tile spreads N 768 over 48 SMs without a split."""
    block_n, k_split = il.plan(M, K, N)
    assert 48 <= -(-M // il.ROW_TILE) * N // block_n * k_split <= 132


def test_indexed_plan_at_the_streaming_linears():
    """K 768 fits the ring (12 steps): no split, the narrowest tile within
    132 blocks: qkv 72 tiles of 32 columns (16 would give 144), o 48 and
    gate/up 128 tiles of 16.  K 2048 (32 steps) does not: the largest grid,
    the wider tile on a tie: down 12 tiles x 8 (over 24 x 4 and 48 x 2)."""
    assert [il.ring_steps(b) for b in il.COLUMN_TILES] == [13, 16, 16]
    assert il.plan(60, 768, 2304) == (32, 1)
    assert il.plan(60, 768, 768) == (16, 1)
    assert il.plan(60, 768, 2048) == (16, 1)
    assert il.plan(60, 2048, 768) == (64, 8)


@pytest.mark.parametrize("M,K,N,want", [(661, 768, 2304, (64, 1)), (60, 4096, 11008, (64, 1)),
                                        (661, 768, 768, (64, 1)), (60, 11008, 4096, (64, 2))])
def test_indexed_plan_where_the_column_tiles_alone_fill_the_card(M, K, N, want):
    """Many rows or wide N: 64-column tiles without a split where even they
    pass 132 blocks; (60, 11008, 4096) splits K in 2 (128 blocks)."""
    assert il.plan(M, K, N) == want


@pytest.mark.parametrize("M", [1, 60, 61, 64, 65, 661])
@pytest.mark.parametrize("K,N", [(128, 128), (128, 256), (768, 2304), (2048, 768),
                                 (4096, 11008), (11008, 4096), (384, 640)])
def test_indexed_plan_covers_k_exactly_for_every_supported_shape(M, K, N):
    """Every (K, N) ``supported`` takes (multiples of 128) gets a plan whose
    column tile divides N and whose K split is a cluster of 1..8 blocks,
    each a run of whole 64-deep steps that together cover K exactly."""
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(1, N, K, dtype=torch.bfloat16)
    assert il.supported(x, w)
    block_n, k_split = il.plan(M, K, N)
    assert block_n in il.COLUMN_TILES and N % block_n == 0
    assert 1 <= k_split <= il.MAX_K_SPLIT
    steps = K // il.K_STEP
    assert steps % k_split == 0
    runs = [range(r * steps // k_split, (r + 1) * steps // k_split) for r in range(k_split)]
    assert sorted(s for run in runs for s in run) == list(range(steps))


def test_indexed_plan_takes_the_most_blocks_below_a_wave():
    """A shape too small for a wave gets the plan with the most blocks
    among those without a split (its 2 K steps fit any ring)."""
    assert il.plan(1, 128, 128) == (16, 1)  # 8 column tiles
