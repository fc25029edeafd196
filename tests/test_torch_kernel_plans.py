"""The launch plans of the port's kernels, plain Python, on the CPU.

The slab decode, the indexed linear, w8a16, short attention, the flash
backward, exact attention and the segment sum.

All are plain Python functions of the shapes (``ops/decode_attention.
split_plan``, ``ops/indexed_linear.plan``, ``ops/quant_matmul.plan``,
``ops/short_attention.plan``, ``ops/flash_attention.query_tiles`` and
``key_tiles``), so they are held here, on the CPU: every
key tile lies in exactly one split and no split is empty; a K split
covers K in whole steps (64 deep in the indexed linear, 128 in w8a16)
with a cluster the kernel accepts; the streaming step's decode fills a
wave of the H100's 132 SMs and its linears run at most one block an SM,
unsplit where the K run fits the kernel's ring; w8a16 takes the sweep's
plans on its main path; short attention's query tiles cover every row
once; the flash backward's dq blocks cover every query row and its dk/dv
blocks every key once, each streaming exactly the 64-row tiles the causal
mask needs, longest walk first, and so do the blocks of exact attention
(``ops/exact_attention.query_tiles``, ``walk``); the segment sum
(``ops/segment_ops.sum_walk``, ``narrow_chunks``) adds every kept edge
once, in ascending order within each row, walks a long run chunk after
chunk or round after round, and starts the long rows first
(``SegmentIndex.long_first``); every shape
``supported`` accepts gets a plan.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa
from fluid_llm_tpu_torch.ops import indexed_linear as il
from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.ops import segment_ops as so
from fluid_llm_tpu_torch.ops import short_attention as sa

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


# -- w8a16 (ops/quant_matmul.plan) and short attention (ops/short_attention.plan)

# (M, K, N) of the w8a16 kernel's main path: OPT-125m's q/k/v/o, fc1 and fc2
# at the exact rollout's 661 rows and the sliced last block's 60
W8A16_MAIN = [(661, 768, 768), (661, 768, 3072), (661, 3072, 768),
              (60, 768, 768), (60, 768, 3072), (60, 3072, 768)]


@pytest.mark.parametrize("M", [1, 60, 61, 64, 65, 661])
@pytest.mark.parametrize("K,N", [(128, 16), (768, 768), (768, 3072), (3072, 768), (2048, 768),
                                 (384, 80), (11008, 4096)])
def test_w8a16_plan_covers_k_exactly_for_every_supported_shape(M, K, N):
    """Every (K, N) ``supported`` takes gets a plan the kernel takes: one
    of its token tiles and a K split that is a cluster of 1..8 blocks,
    each a run of whole 128-deep steps that together cover K."""
    assert qmm.supported(K, N)
    tile, k_split = qmm.plan(M, K, N)
    assert tile in qmm.W16_TOKEN_TILES
    assert 1 <= k_split <= qmm.MAX_K_SPLIT
    steps = K // qmm.W16_K_STEP
    assert steps % k_split == 0
    runs = [range(r * steps // k_split, (r + 1) * steps // k_split) for r in range(k_split)]
    assert sorted(s for run in runs for s in run) == list(range(steps))
    assert (-(-N // qmm.W16_ROWS) * k_split * -(-M // tile), tile, k_split) in qmm.plans(M, K, N)


@pytest.mark.parametrize("M,K,N", W8A16_MAIN)
def test_w8a16_plan_at_the_main_path_is_the_sweeps(M, K, N):
    """The main path's six shapes take the sweep's fastest plan, one the
    kernel takes; the 60-row shapes spread over more blocks than the
    first port's 48 (K split or not), and no grid passes two waves of the
    H100's 132 SMs."""
    p = qmm.plan(M, K, N)
    assert p == qmm.SWEPT_PLANS[M, K, N]
    blocks = [b for b, *rest in qmm.plans(M, K, N) if tuple(rest) == p]
    assert len(blocks) == 1 and blocks[0] <= 2 * 132
    if M == 60:
        assert blocks[0] >= 48


def test_w8a16_plan_elsewhere_follows_the_sweeps_rule():
    """Off the swept shapes (or on another card): unsplit where an
    unsplit grid within the SM count fills a third of it, else the
    largest grid with a K split; the fewest blocks where
    every unsplit grid passes the SM count.  The rule gives the sweep's
    choice at five of the six swept shapes (with one SM more, so that the
    table of swept plans is not read)."""
    assert qmm.plan(60, 768, 2048) == (64, 3)  # 32 unsplit blocks: too few of 132
    assert qmm.plan(60, 768, 2048, 90) == (64, 1)  # but a third of 90
    assert qmm.plan(661, 768, 768, 114) == (128, 1)  # 72 blocks within 114
    assert qmm.plan(661, 2048, 8192) == (224, 1)  # 384 blocks: every grid past 132
    agree = [qmm.plan(M, K, N, 133) == qmm.SWEPT_PLANS[M, K, N] for M, K, N in W8A16_MAIN]
    assert sum(agree) >= 5


@pytest.mark.parametrize("L", [1, 16, 63, 64, 65, 129, 601, 661, 1536])
@pytest.mark.parametrize("q_rows", sa.QUERY_ROWS)
def test_short_query_tiles_cover_every_row_once_longest_first(L, q_rows):
    """The blocks of one (batch, head) cover query rows 0..L-1 once, in
    whole tiles of the block's rows but the last, the tile with the most
    keys to walk first."""
    tiles = sa.query_tiles(L, q_rows)
    assert sorted(i for t in tiles for i in t) == list(range(L))
    assert all(len(t) == q_rows for t in tiles[1:])
    assert [t.start for t in tiles] == sorted((t.start for t in tiles), reverse=True)


@pytest.mark.parametrize("bs,L,H,hd", [(8, 601, 12, 64), (1, 661, 12, 64), (1, 1, 1, 64),
                                       (2, 1536, 2, 128), (4, 300, 16, 128)])
def test_short_plan_is_a_kernel_template(bs, L, H, hd):
    """The plan is one of the kernel's two block heights for every shape
    ``supported`` accepts; two warpgroups only where that grid still fills
    the card."""
    assert sa.supported(L, hd)
    q_rows = sa.plan(bs, L, H, hd)
    assert q_rows in sa.QUERY_ROWS
    if q_rows == 128:
        assert bs * H * len(sa.query_tiles(L, 128)) >= 132


# -- the flash backward (ops/flash_attention.query_tiles, key_tiles, walk)

FLASH_LENGTHS = [1, 5, 63, 64, 65, 128, 129, 601, 661, 1536]


@pytest.mark.parametrize("L", FLASH_LENGTHS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_flash_tiles_cover_every_row_once_and_walk_what_the_mask_needs(kernel, L):
    """The blocks of one (batch, head) cover the query rows (dq) or the keys
    (dk/dv) 0..L-1 once, in whole 64-row tiles but the last; each streams
    exactly the 64-row tiles holding a (query, key) pair the causal mask
    allows for one of its rows: keys up to its last query (dq), queries
    from its first key on (dk/dv)."""
    tiles = fa.query_tiles(L) if kernel == "dq" else fa.key_tiles(L)
    assert sorted(i for t in tiles for i in t) == list(range(L))
    assert sum(len(t) != fa.TILE for t in tiles) <= 1 and len(tiles[0 if kernel == "dkv" else -1]) \
        == min(fa.TILE, L)
    causal = torch.ones(L, L, dtype=torch.bool).tril()  # [query, key]
    for t in tiles:
        seen = causal[t.start:t.stop].any(0) if kernel == "dq" else causal[:, t.start:t.stop].any(1)
        streamed = {int(i) // fa.TILE for i in seen.nonzero().flatten()}
        assert fa.walk(kernel, L, t) == len(streamed)
        assert streamed == set(range(min(streamed), min(streamed) + len(streamed)))


@pytest.mark.parametrize("L", FLASH_LENGTHS)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_flash_block_order_puts_the_longest_walk_first(kernel, L):
    """Blocks start in launch order longest walk first, so that the short
    walks fill the tail: the last query tiles for dq, the first key tiles
    for dk/dv."""
    tiles = fa.query_tiles(L) if kernel == "dq" else fa.key_tiles(L)
    walks = [fa.walk(kernel, L, t) for t in tiles]
    assert walks == sorted(walks, reverse=True)
    assert walks[0] == -(-L // fa.TILE)  # the longest block streams every tile


def test_flash_tile_is_the_kernels():
    """The tiles above are the kernels' own: ``TILE`` is the rows of a
    block and of each streamed tile in ``csrc/flash_attention.cu``."""
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    assert re.search(r"^constexpr int T = (\d+);", src, re.M).group(1) == str(fa.TILE)


# -- exact attention and the flash forward (ops/exact_attention.query_tiles, walk)


@pytest.mark.parametrize("L", FLASH_LENGTHS)
def test_exact_tiles_cover_every_row_once_longest_walk_first(L):
    """The blocks of one (batch, head) cover the query rows 0..L-1 once, in
    launch order longest walk first; each streams the key tiles from 0 up
    to the one holding its last row: exactly those with a key the causal
    mask allows one of its rows."""
    tiles = xa.query_tiles(L)
    assert sorted(i for t in tiles for i in t) == list(range(L))
    causal = torch.ones(L, L, dtype=torch.bool).tril()  # [query, key]
    walks = []
    for t in tiles:
        seen = causal[t.start:t.stop].any(0)
        assert {int(i) // xa.TILE for i in seen.nonzero().flatten()} == set(range(xa.walk(t)))
        walks.append(xa.walk(t))
    assert walks == sorted(walks, reverse=True) and walks[0] == -(-L // xa.TILE)
    assert fa.query_tiles(L) == tiles  # the dq kernel's blocks are the forward's


def test_exact_tile_is_the_kernels():
    """``TILE`` is the rows of a block and of each streamed key tile in
    ``csrc/exact_attention.cu``."""
    src = (Path(xa.__file__).parents[1] / "csrc" / "exact_attention.cu").read_text()
    assert re.search(r"^constexpr int T = (\d+);", src, re.M).group(1) == str(xa.TILE)


# -- the segment sum (ops/segment_ops.narrow_chunks, sum_walk)


def _segment_index_with_a_long_row():
    """Sorted ids of 3 graphs of 257 nodes with dropped ids (the ghost slot
    N, beyond it, negative), row 40 of graph 1 named by 132 edges more, as
    the EAGLE collate's ghost row is, and row 200 of graph 2 by 700 more:
    longer than a narrow warp's chunk."""
    g = torch.Generator().manual_seed(3)
    B, E, N = 3, 2000, 257
    ids = torch.sort(torch.randint(0, N, (B, E), generator=g), dim=1).values
    ids[1, 300:432] = 40
    ids[2, 1000:1700] = 200
    ids[:, -40:] = N
    ids[0, 3:9] = N + 11
    ids[2, 100] = -5
    return so.SegmentIndex(ids, N), (N + 40, 2 * N + 200)


@pytest.mark.parametrize("F", [1, 2, 3, 31, 32, 33, 128])
def test_segment_walk_adds_every_kept_edge_once_in_ascending_order(F):
    """Each output element (r, c) adds exactly its row's edges, ascending,
    each once; the dropped ids in no row.  Narrow warps (F < WIDE) stage
    their rows' stretch of perm in chunks that cover it once, in order, at
    most CHUNK_EDGES edges and CHUNK_FLOATS values each (the 700-edge row
    takes two chunks at F 1); wide rows walk rounds of ROUND edges (the
    132-edge row takes 17)."""
    index, (long_row, longer_row) = _segment_index_with_a_long_row()
    perm, row_ptr = index.csr()
    rp = row_ptr.tolist()
    taken = set()
    for r in range(index.n_rows):
        for c in range(F):
            walk = so.sum_walk(rp, F, r, c)
            assert [j for run in walk for j in run] == list(range(rp[r], rp[r + 1]))
            taken.update(int(perm[j]) for run in walk for j in run)
    assert sorted(taken) == (index.ids >= 0).nonzero().flatten().tolist()
    for r in range(index.n_rows):  # the CSR: each row's edges ascending, all its own
        run = perm[rp[r]:rp[r + 1]].tolist()
        assert run == sorted(run) and all(int(index.ids[e]) == r for e in run)
    if F < so.WIDE:
        for warp in range(-(-index.n_rows * F // 32)):
            chunks = so.narrow_chunks(rp, F, warp)
            first, last = 32 * warp // F, min((32 * warp + 31) // F, index.n_rows - 1)
            assert [j for k in chunks for j in k] == list(range(rp[first], rp[last + 1]))
            assert all(len(k) <= min(so.CHUNK_EDGES, so.CHUNK_FLOATS // F) for k in chunks)
        assert len(so.sum_walk(rp, F, longer_row, 0)) >= 2
    else:
        walk = so.sum_walk(rp, F, long_row, 0)
        assert all(len(run) <= so.ROUND for run in walk)
        assert len(walk) == -(-(rp[long_row + 1] - rp[long_row]) // so.ROUND) >= 17


def test_segment_long_rows_start_first():
    """``long_first`` is a permutation of the rows: those with more than
    ROUND edges (the long row among them), then the others, each part in
    row order."""
    index, (long_row, longer_row) = _segment_index_with_a_long_row()
    row_ptr = index.csr()[1]
    degree = (row_ptr[1:] - row_ptr[:-1]).tolist()
    order = index.long_first()
    assert order.dtype == torch.int32
    long = [r for r in range(index.n_rows) if degree[r] > so.ROUND]
    assert long_row in long and longer_row in long
    assert order.tolist() == long + [r for r in range(index.n_rows) if degree[r] <= so.ROUND]
    assert index.long_first() is order  # built once


def test_segment_plan_is_the_kernels():
    """``WIDE``, ``ROUND``, ``CHUNK_EDGES`` and ``CHUNK_FLOATS`` are the sum
    kernels' own (``csrc/segment_ops.cu``)."""
    src = (Path(so.__file__).parents[1] / "csrc" / "segment_ops.cu").read_text()
    for name in ("WIDE", "ROUND", "CHUNK_EDGES", "CHUNK_FLOATS"):
        got = re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1)
        assert got == str(getattr(so, name)), name


@pytest.mark.parametrize("F", [1, 2, 32, 128])
def test_csr_walk_is_the_twin_bit_for_bit_with_a_long_row(F):
    """``csr_walk`` (the kernel's order of additions, one round per edge
    rank) equals the CPU twin bit for bit, the long row included: the
    card tests and chip_smoke hold the kernel to it."""
    index, _ = _segment_index_with_a_long_row()
    vals = torch.randn(index.ids.shape[0], F, generator=torch.Generator().manual_seed(F))
    assert torch.equal(so.csr_walk(vals, index), so.segment_sum_ref(vals, index))
