"""The launch plans of the port's kernels, plain Python, on the CPU.

The slab decode, the indexed linear, w8a16, w8a8, short attention, the
flash backward, exact attention, the segment sum and gather and the
slot-attention forward and backward.

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
(``SegmentIndex.long_first``); the gather's warps
(``ops/segment_ops.gather_plan``, ``gather_tiles``) write every vector of
every edge row once; the slot-attention backward's and forward's strip
walks (``ops/grid_gnn_fused.bwd_plan``, ``fwd_plan``, ``strips``), walked
in numpy, equal their twins, and the forward's plan fills the card at the
rollout's one frame and fits every width the wrapper takes; the learned
positions' backward (``ops/pos_embed.grad_plan``) covers every row and
column once within the kernel's bounds; the kernels' constants are read
from their sources; every shape ``supported`` accepts
gets a plan, w8a8's covering N and K exactly.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa
from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
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


@pytest.mark.parametrize("F", [32, 36, 128, 512, 1536])
def test_bf16_ring_plan_fits_and_every_row_is_taken_once(F):
    """``sum_plan``'s ring fits a block's shared memory and launches within
    the kernel's bounds; its warps (``ring_walk``), and those of plans with
    fewer rows in flight than the long row's edges, take every slice of
    every row exactly once, each row's edges ascending; warp g starts with
    task g of the long-first order, so that where the warps outnumber the
    long rows the 132- and 700-edge rows each start a warp.  Rows past
    RING_SLICE bytes (F 1536) are cut into slices."""
    index, (long_row, longer_row) = _segment_index_with_a_long_row()
    perm, row_ptr = index.csr()
    rp, order = row_ptr.tolist(), index.long_first().tolist()
    slices = -(-2 * F // min(2 * F, so.RING_SLICE))
    n_long = sum(rp[r + 1] - rp[r] > so.ROUND for r in range(index.n_rows))
    B = so.LONG_BLOCKS
    for plan in (so.sum_plan(F), (1, 2, 1, 1), (4, 2, 3, 2), (32, 1, 32, 16)):
        K, S, R, W = plan
        assert 32 % K == 0 and S >= 1 and 1 <= R <= 32 and 1 <= W <= so.RING_WARPS
        assert so.ring_smem(F, plan) <= so.SMEM_MAX or plan != so.sum_plan(F)
        walk = so.ring_walk(rp, order, F, plan)
        taken = [(row, sl) for warp in walk for row, sl, _ in warp]
        assert sorted(taken) == [(r, sl) for r in range(index.n_rows) for sl in range(slices)]
        assert all(len(warp) == 1 for warp in walk[:B]) and all(len(w) <= R for w in walk)
        for warp in walk:
            for row, _, run in warp:
                assert run == list(range(rp[row], rp[row + 1]))
        # warp g starts with task g of the long-first order and goes on in it
        assert [warp[0][:2] for warp in walk] == [(order[t // slices], t % slices)
                                                 for t in range(len(walk))]
        pos = {r: i for i, r in enumerate(order)}
        assert all([pos[row] for row, _, _ in warp] == sorted(pos[row] for row, _, _ in warp)
                   for warp in walk)
        if len(walk) >= n_long * slices:  # a warp for each long row's slice, first
            assert {long_row, longer_row} <= {warp[0][0] for warp in walk}
    K, S, R, W = so.sum_plan(F)
    assert rp[long_row + 1] - rp[long_row] == 132 > K * S  # a warp's ring streams it through


def test_bf16_ring_plan_at_the_graph_shapes_and_is_the_kernels():
    """At MeshGraphNet's F 128 a long row's block holds its 132 edges in
    flight at once, and at GraphViT's F 512 (no long rows) a warp holds its
    rows; RING_SLICE, RING_WARPS, LONG_BLOCKS and SMEM_MAX are the kernel's
    (``csrc/segment_ops.cu``, ``csrc/hopper.cuh``)."""
    K, S, R, W = so.sum_plan(128)
    assert W * S * K >= 132 and so.LONG_BLOCKS >= 4  # a ghost row of each of MGN's 4 graphs
    K, S, R, W = so.sum_plan(512)
    assert S * K >= R  # GraphViT's members: one edge a row
    for F in (128, 512):
        assert so.ring_smem(F, so.sum_plan(F)) <= so.SMEM_MAX
    csrc = Path(so.__file__).parents[1] / "csrc"
    src = (csrc / "segment_ops.cu").read_text()
    for name in ("RING_SLICE", "RING_WARPS", "LONG_BLOCKS"):
        got = re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1)
        assert got == str(getattr(so, name)), name
    got = re.search(r"constexpr int SMEM_MAX = (\d+);", (csrc / "hopper.cuh").read_text())
    assert got.group(1) == str(so.SMEM_MAX)


@pytest.mark.parametrize("F", [1, 2, 32, 128])
def test_csr_walk_is_the_twin_bit_for_bit_with_a_long_row(F):
    """``csr_walk`` (the kernel's order of additions, one round per edge
    rank) equals the CPU twin bit for bit, the long row included: the
    card tests and chip_smoke hold the kernel to it."""
    index, _ = _segment_index_with_a_long_row()
    vals = torch.randn(index.ids.shape[0], F, generator=torch.Generator().manual_seed(F))
    assert torch.equal(so.csr_walk(vals, index), so.segment_sum_ref(vals, index))


# -- w8a8 (ops/quant_matmul.w8a8_plan, w8a8_plans)

# (M, K, N) of chip_smoke.py phase 3's w8a8 rows: the flagship's streaming
# linears at 60 rows (61 in the prefill), OPT-125m's at the exact rollout's 661
W8A8_SHAPES = [(M, K, N) for M in (60, 61) for K, N in ((768, 768), (768, 2048), (2048, 768))] + [
    (661, 768, 768), (661, 768, 3072), (661, 3072, 768)]


@pytest.mark.parametrize("M", [1, 60, 61, 64, 65, 661])
@pytest.mark.parametrize("K,N", [(128, 16), (768, 768), (768, 2048), (2048, 768), (768, 3072),
                                 (3072, 768), (384, 80), (11008, 4096), (28672, 8192)])
def test_w8a8_plan_covers_k_and_n_exactly_for_every_supported_shape(M, K, N):
    """Every (K, N) ``supported`` takes gets a plan the kernel takes: one of
    its column tiles, whose tiles cover N (the last one partial where N is
    not a multiple: rows past N read as zeros and are not written), and a
    K split that is a cluster of 1..8 blocks, each a non-empty run of whole
    128-deep steps, the runs covering K once in rank order."""
    assert qmm.supported(K, N)
    n_tile, k_split = qmm.w8a8_plan(M, K, N)
    assert n_tile in qmm.W8_COL_TILES and 1 <= k_split <= qmm.MAX_K_SPLIT
    tiles = [range(t * n_tile, min(N, (t + 1) * n_tile)) for t in range(-(-N // n_tile))]
    assert [n for t in tiles for n in t] == list(range(N))
    steps = K // qmm.W8_K_STEP  # rank r: steps [r T / n, (r + 1) T / n), as the kernel splits
    runs = [range(r * steps // k_split, (r + 1) * steps // k_split) for r in range(k_split)]
    assert all(len(r) >= 1 for r in runs)
    assert [s for r in runs for s in r] == list(range(steps))
    blocks = -(-N // n_tile) * k_split * -(-M // qmm.W8_ROWS)
    assert (blocks, n_tile, k_split) in qmm.w8a8_plans(M, K, N)


@pytest.mark.parametrize("M,K,N", W8A8_SHAPES)
def test_w8a8_plan_at_phase_3_shapes(M, K, N):
    """At the nine shapes chip_smoke times, the plan is the sweep's where it
    has run (``W8A8_SWEPT_PLANS``), and the 60/61-row grids spread the
    weight over more blocks than the first port's 48."""
    p = qmm.w8a8_plan(M, K, N)
    if (M, K, N) in qmm.W8A8_SWEPT_PLANS:
        assert p == qmm.W8A8_SWEPT_PLANS[M, K, N]
    blocks = [b for b, *rest in qmm.w8a8_plans(M, K, N) if tuple(rest) == p]
    assert len(blocks) == 1
    if M < 64:
        assert blocks[0] >= 48


def test_w8a8_plan_is_the_kernels():
    """The column tiles, the token tile, the K step and the cluster limit
    are the w8a8 kernel's own (``csrc/quant_matmul.cu``)."""
    src = (Path(qmm.__file__).parents[1] / "csrc" / "quant_matmul.cu").read_text()
    entry = src[src.index('extern "C" int quant_matmul_w8a8'):src.index('extern "C" int quant_matmul_w8a16')]
    assert tuple(int(t) for t in re.findall(r"case (\d+):", entry)) == qmm.W8_COL_TILES
    for name, value in (("Q8_ROWS", qmm.W8_ROWS), ("Q8_BK", qmm.W8_K_STEP),
                        ("Q8_MAX_CLUSTER", qmm.MAX_K_SPLIT)):
        assert re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1) == str(value)


# -- the slot-attention backward (ops/grid_gnn_fused.bwd_plan, strips)


def _lrelu(u):
    return np.where(u > 0, u, np.float32(gf.NEG_SLOPE) * u)


def _slot_bwd_walk(xl, xr, att, g, H, C, plan):
    """The backward kernel's plan walked in numpy f32: for each block (frame,
    strip of STRIP rows, column tile) a ring of ``stages`` row units (unit j:
    xl row x0 - 2 + j, xr and g row x0 - 3 + j) filled in order by a
    producer that runs as far ahead as the released units let it (unit j
    may replace unit j - stages once step j - stages + LIVE_UNITS - 1 is
    done), a STAT_RING-row ring of alpha/dlogit, dxr of each own row at its
    stat step and dxl of the row behind it, datt partials per pixel slot of
    the block's threads summed in slot order, then the blocks' partials in
    the reducing launch's order.  Row buffers start as NaN, so a read of an
    element no copy brought in shows in the result.  Returns (dxl, dxr,
    datt, stat rows computed per (frame, row))."""
    Bf, X, Y, F = xl.shape
    ytile, stages, group = plan
    PT = gf.bwd_threads(ytile, H, C) // (H * group)  # pixels a pass: the threads' pixel slots
    att = att.astype(np.float32)
    dxl = np.full(xl.shape, np.nan, np.float32)
    dxr = np.full(xl.shape, np.nan, np.float32)
    written = np.zeros((2, Bf, X, Y), int)
    stat_rows = np.zeros((Bf, X), int)
    partial = []
    for b in range(Bf):
        for x0, x1 in gf.strips(X):
            for y0 in range(0, Y, ytile):
                y1 = min(y0 + ytile, Y)
                n_units = x1 - x0 + 4
                ring = [None] * stages
                stats = [None] * gf.STAT_RING
                acc = np.zeros((PT, H, C), np.float32)
                loaded, released = 0, -1

                def load(j):
                    assert ring[j % stages] is None or ring[j % stages][0] <= released
                    r = x0 - 2 + j
                    bufs = np.full((3, ytile + 4, H, C), np.nan, np.float32)
                    if 0 <= r < X:
                        ll, lh = max(y0 - 2, 0), min(y1 + 2, Y)
                        bufs[0, ll - y0 + 2:lh - y0 + 2] = xl[b, r, ll:lh].reshape(-1, H, C)
                    if 0 <= r - 1 < X and j >= 2:
                        rl, rh = max(y0 - 1, 0), min(y1 + 1, Y)
                        bufs[1, rl - y0 + 2:rh - y0 + 2] = xr[b, r - 1, rl:rh].reshape(-1, H, C)
                        bufs[2, rl - y0 + 2:rh - y0 + 2] = g[b, r - 1, rl:rh].reshape(-1, H, C)
                    ring[j % stages] = (j, bufs)

                def unit(j):
                    assert ring[j % stages][0] == j  # the ring still holds it
                    return ring[j % stages][1]

                def stat(row):
                    assert stats[(row - x0 + 1) % gf.STAT_RING][0] == row
                    return stats[(row - x0 + 1) % gf.STAT_RING][1:]

                for j in range(n_units):
                    while loaded < min(n_units, j + stages - gf.LIVE_UNITS + 1):
                        load(loaded)
                        loaded += 1
                    i = x0 - 3 + j
                    if j >= 2 and 0 <= i < X:
                        stat_rows[b, i] += 1
                        ys = np.arange(max(y0 - 1, 0), min(y1 + 1, Y))
                        bi = ys - y0 + 2
                        lm, l0, lp = unit(j - 2)[0], unit(j - 1)[0], unit(j)[0]
                        r0, g0 = unit(j)[1][bi], unit(j)[2][bi]
                        vals = [l0[bi], lm[bi], lp[bi], l0[bi - 1], l0[(bi + 1) % (ytile + 4)]]
                        valid = [np.ones(len(ys), bool), np.full(len(ys), i > 0),
                                 np.full(len(ys), i < X - 1), ys > 0, ys < Y - 1]
                        lg = np.stack([np.where(v[:, None], (_lrelu(r0 + s) * att).sum(-1), 0)
                                       for s, v in zip(vals, valid)])  # (5, ny, H)
                        gv = np.stack([np.where(v[:, None], (g0 * s).sum(-1), 0)
                                       for s, v in zip(vals, valid)])
                        vmask = np.stack(valid)[:, :, None]
                        m = np.where(vmask, lg, -np.inf).max(0)
                        w = np.where(vmask, np.exp(lg - m), 0).astype(np.float32)
                        alpha = w / w.sum(0)
                        dl = alpha * (gv - (alpha * gv).sum(0))
                        stats[(i - x0 + 1) % gf.STAT_RING] = (i, ys[0], alpha, dl)
                        if x0 <= i < x1:
                            own = (ys >= y0) & (ys < y1)
                            o = np.zeros((own.sum(), H, C), np.float32)
                            dat = np.zeros_like(o)
                            for s, (v, ok) in enumerate(zip(vals, valid)):
                                u = (r0 + v)[own]
                                o += np.where(ok[own, None, None],
                                              dl[s][own][..., None] * np.where(u > 0, 1, gf.NEG_SLOPE), 0)
                                dat += np.where(ok[own, None, None], dl[s][own][..., None] * _lrelu(u), 0)
                            dxr[b, i, y0:y1] = (o * att).reshape(-1, F)
                            written[1, b, i, y0:y1] += 1
                            for y, d in zip(ys[own], dat):
                                acc[(y - ys[0]) % PT] += d
                    if j >= 4:
                        q = i - 1
                        ys = np.arange(y0, y1)
                        bi = ys - y0 + 2
                        rows = {r: unit(j - 1 + r - q) for r in (q - 1, q, q + 1)}  # xr, g
                        l = unit(j - 2)[0][bi]
                        o = np.zeros((len(ys), H, C), np.float32)
                        for s, (dx, dy) in enumerate(gf.SHIFTS):
                            p = q - dx  # the source pixel (p, y - dy) whose slot s reads (q, y)
                            ok = (0 <= p < X) & (ys - dy >= 0) & (ys - dy < Y)
                            if not ok.any():
                                continue
                            s0, alpha, dl = stat(p)
                            col = np.clip(ys - dy - s0, 0, len(alpha[s]) - 1)
                            a_s, d_s = alpha[s][col][..., None], dl[s][col][..., None]
                            rr, gg = rows[p][1][bi - dy], rows[p][2][bi - dy]
                            term = a_s * gg + d_s * att * np.where(rr + l > 0, 1, gf.NEG_SLOPE)
                            o += np.where(ok[:, None, None], term, 0)
                        dxl[b, q, y0:y1] = o.reshape(-1, F)
                        written[0, b, q, y0:y1] += 1
                    if j >= gf.LIVE_UNITS - 1:
                        released = j - gf.LIVE_UNITS + 1
                red = np.zeros((H, C), np.float32)
                for p in range(PT):  # the block's partial, pixel slots in order
                    red += acc[p]
                partial.append(red.reshape(F))
    # the reducing launch: thread t sums blocks t, t + 256, ... in order, then a tree
    partial = np.stack(partial)
    sums = np.zeros((gf.DATT_THREADS, F), np.float32)
    for t in range(min(gf.DATT_THREADS, len(partial))):
        for row in partial[t::gf.DATT_THREADS]:
            sums[t] += row
    w = gf.DATT_THREADS // 2
    while w:
        sums[:w] += sums[w:2 * w]
        w //= 2
    assert (written == 1).all()  # every dxl and dxr element written once
    return dxl, dxr, sums[0].reshape(H, C), stat_rows


@pytest.mark.parametrize("Bf,X,Y,H,C,plan", [
    (2, 5, 6, 1, 3, None),  # X < STRIP
    (2, 37, 5, 2, 24, None),  # X not a multiple of STRIP; H 2, C 24
    (1, 1, 4, 1, 8, None),  # X = 1
    (2, 2, 3, 1, 48, None),  # X = 2
    (1, 33, 1, 1, 4, None),  # Y = 1; a strip of 3 rows after the first
    (1, 20, 7, 1, 48, (3, 4, 4)),  # column tiles of 3 and the shortest ring
    (1, 33, 6, 2, 5, (4, 5, 2)),  # C 5: chunks of one channel, two threads a head
])
def test_slot_bwd_strip_walk_is_the_twin(Bf, X, Y, H, C, plan):
    """The strip walk of the backward kernel (R = STRIP rows a block, the
    halo stat rows x0 - 1 and x1, the three-row ring of alpha/dlogit, the
    unit ring, datt summed in block order) equals ``slot_attention_bwd_ref``
    within f32 rounding, and only the halo stat rows at each strip's ends
    are computed twice."""
    rng = np.random.default_rng(X * 100 + Y)
    xl, xr, g = (rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32) for _ in range(3))
    att = rng.normal(size=(H, C)).astype(np.float32)
    plan = plan or gf.bwd_plan(Y, H, C, 2)
    assert plan[1] > gf.LIVE_UNITS and plan[2] == gf.channel_group(C)[1]
    got = _slot_bwd_walk(xl, xr, att, g, H, C, plan)
    want = gf.slot_attention_bwd_ref(*(torch.from_numpy(a) for a in (xl, xr, att, g)), H, C)
    for a, w in zip(got[:3], want):
        w = w.numpy()
        assert np.abs(a - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), np.abs(a - w).max()
    boundary = {x for x0, x1 in gf.strips(X) for x in (x0 - 1, x1) if 0 <= x < X}
    twice = {x for x in boundary for x0, x1 in gf.strips(X) if x0 <= x < x1}
    per_col_tile = -(-Y // plan[0])
    expect = np.array([2 if x in twice else 1 for x in range(X)]) * per_col_tile
    assert (got[3] == expect).all()


def test_slot_bwd_plan_fits_and_takes_whole_rows_at_the_training_shape():
    """At the training decoder's shape (Y 64, H 1, C 48) the bf16 plan takes
    whole rows with a ring of 5 units in half an SM's shared memory (two
    blocks an SM) and 4 threads a pixel; f32 whole rows too, in one SM's;
    the widest shape the wrapper takes (F 256 in f32) tiles its columns."""
    assert gf.bwd_plan(64, 1, 48, 2) == (64, 5, 4)
    assert gf.bwd_smem(64, 5, 1, 48, 2) <= gf.SMEM_SHARED
    assert gf.bwd_plan(64, 1, 48, 4)[:2] == (64, 5)
    ytile, stages, _ = gf.bwd_plan(64, 1, 256, 4)
    assert ytile < 64 and gf.bwd_smem(ytile, stages, 1, 256, 4) <= gf.SMEM_MAX
    assert gf.bwd_blocks(80, 240, 64, 64) == 80 * 8
    for H, C in ((1, 48), (1, 3), (2, 24), (2, 4), (1, 255), (16, 16), (256, 1), (1, 5)):
        vec, group, chunks = gf.channel_group(C)
        assert group & (group - 1) == 0 and group <= 32 and chunks <= 8
        assert -(-(C // vec) // group) == chunks and H * group <= gf.BWD_THREADS
        for Y, elem in ((3, 2), (64, 2), (7, 4), (64, 4)):
            ytile, stages, _ = gf.bwd_plan(Y, H, C, elem)
            # every region on 16 bytes: the rings, att's and the zero pixel's 16-byte loads
            assert gf.bwd_smem(ytile, stages, H, C, elem) % 16 == 0
            assert 32 <= gf.bwd_threads(ytile, H, C) <= gf.BWD_THREADS


def test_slot_bwd_plan_is_the_kernels():
    """``STRIP``, ``BWD_THREADS``, ``STAT_RING``, ``LIVE_UNITS`` and
    ``DATT_THREADS`` are the backward kernel's own
    (``csrc/grid_slot_attention.cu``), and ``SMEM_MAX`` the one
    ``csrc/hopper.cuh`` allows a block."""
    csrc = Path(gf.__file__).parents[1] / "csrc"
    src = (csrc / "grid_slot_attention.cu").read_text()
    for name in ("STRIP", "BWD_THREADS", "STAT_RING", "LIVE_UNITS", "DATT_THREADS"):
        got = re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1)
        assert got == str(getattr(gf, name)), name
    hop = (csrc / "hopper.cuh").read_text()
    assert re.search(r"constexpr int SMEM_MAX = (\d+);", hop).group(1) == str(gf.SMEM_MAX)


# -- the slot-attention forward (ops/grid_gnn_fused.fwd_plan, strips)


def _slot_fwd_walk(xl, xr, att, H, C, plan):
    """The forward kernel's plan walked in numpy f32: for each block (frame,
    strip of ``strip`` rows, column tile) a ring of ``stages`` units of
    ``rows`` rows (unit u, row k: xl row x0 - 1 + u rows + k, xr row x0 - 2
    + u rows + k) filled in order by a producer that runs as far ahead as
    the released units let it, and steps of ``rows`` rows: step J writes out
    rows x0 + J rows + w (w < rows) from the units holding xl rows i - 1, i,
    i + 1 and xr row i, then releases unit J.  Each thread of a pixel's
    group sums the logits of its chunks (chunk c to thread c % group), an
    xor tree sums the group's partials, a slot off the grid reads the zero
    pixel and is masked out of the softmax.  Row buffers start as NaN, so a
    read of an element no copy brought in shows in the result.  Returns
    (out, writes per output pixel)."""
    Bf, X, Y, F = xl.shape
    strip, ytile, stages, group, rows = plan
    vec = gf.channel_group(C)[0]
    ch = C // vec
    att = att.astype(np.float32)
    zero = np.zeros((H, C), np.float32)
    out = np.full(xl.shape, np.nan, np.float32)
    written = np.zeros((Bf, X, Y), int)
    for b in range(Bf):
        for x0, x1 in gf.strips(X, strip):
            for y0 in range(0, Y, ytile):
                y1 = min(y0 + ytile, Y)
                n_units = (x1 - x0 + 1 + rows) // rows
                ring = [None] * stages
                loaded, released = 0, -1

                def load(u):
                    assert ring[u % stages] is None or ring[u % stages][0] <= released
                    bufs = np.full((2, rows, ytile + 2, H, C), np.nan, np.float32)
                    for k in range(rows):
                        r = x0 - 1 + u * rows + k
                        if 0 <= r < X and r <= x1:
                            ll, lh = max(y0 - 1, 0), min(y1 + 1, Y)
                            bufs[0, k, ll - y0 + 1:lh - y0 + 1] = xl[b, r, ll:lh].reshape(-1, H, C)
                        if x0 <= r - 1 < x1:
                            bufs[1, k, 1:y1 - y0 + 1] = xr[b, r - 1, y0:y1].reshape(-1, H, C)
                    ring[u % stages] = (u, bufs)

                def unit(u):
                    assert ring[u % stages][0] == u  # the ring still holds it
                    return ring[u % stages][1]

                for J in range(n_units):
                    while loaded < min(n_units, released + 1 + stages):
                        load(loaded)
                        loaded += 1
                    for w in range(rows):
                        if J * rows + w >= x1 - x0:
                            continue
                        i = x0 + J * rows + w
                        ys = np.arange(y0, y1)
                        yi = ys - y0 + 1
                        held = [unit(J + (w + d) // rows)[:, (w + d) % rows] for d in range(3)]
                        lm, l0, lp, r0 = held[0][0], held[1][0], held[2][0], held[2][1]
                        valid = [np.ones(len(ys), bool), np.full(len(ys), i > 0),
                                 np.full(len(ys), i < X - 1), ys > 0, ys < Y - 1]
                        srcs = [l0[yi], lm[yi], lp[yi], l0[yi - 1], l0[yi + 1]]
                        v = np.stack([np.where(ok[:, None, None], src, zero)
                                      for src, ok in zip(srcs, valid)])  # (5, ny, H, C)
                        e = _lrelu(r0[yi][None] + v) * att
                        chunk = e.reshape(*e.shape[:-1], ch, vec).sum(-1)
                        owner = np.arange(ch) % group
                        lg = np.stack([chunk[..., owner == s].sum(-1) for s in range(group)], -1)
                        o = 1
                        while o < group:  # the xor shuffles
                            lg = lg + lg[..., np.arange(group) ^ o]
                            o *= 2
                        assert (lg == lg[..., :1]).all()  # the same bits in every thread
                        lg = lg[..., 0]
                        mask = np.stack(valid)[:, :, None]
                        m = np.where(mask, lg, -np.inf).max(0)
                        ew = np.where(mask, np.exp(lg - m), 0).astype(np.float32)
                        res = (ew[..., None] * v).sum(0) * (1 / ew.sum(0))[..., None]
                        out[b, i, y0:y1] = res.reshape(-1, F)
                        written[b, i, y0:y1] += 1
                    released = J
    return out, written


@pytest.mark.parametrize("Bf,X,Y,H,C,plan", [
    (2, 5, 6, 1, 3, (8, 6, 4, 1, 4)),  # X < strip; C 3; units of 4 rows, the last short
    (2, 37, 5, 2, 24, (30, 5, 5, 2, 1)),  # X not a multiple of the strip; H 2, C 24
    (1, 1, 4, 1, 8, (30, 4, 4, 1, 1)),  # X = 1
    (1, 1, 4, 1, 8, (30, 4, 4, 1, 2)),  # X = 1 in units of 2 rows
    (1, 33, 1, 1, 4, (4, 1, 6, 1, 3)),  # Y = 1; strips of 4, the last of one row; units of 3
    (1, 20, 7, 1, 48, (3, 3, 4, 4, 1)),  # column tiles of 3 and the shortest ring
    (1, 33, 6, 2, 5, (7, 6, 5, 2, 2)),  # C 5: chunks of one channel, two threads a head
    (3, 10, 8, 1, 48, (2, 8, 6, 4, 1)),  # strips of 2 rows
    (2, 20, 8, 1, 3, (9, 8, 4, 1, 5)),  # units of 5 rows, strips of 9 (two units and a half)
    (1, 9, 4, 1, 48, None), (2, 40, 64, 1, 3, None),  # the plans the wrapper takes
])
def test_slot_fwd_strip_walk_is_the_twin(Bf, X, Y, H, C, plan):
    """The strip walk of the forward kernel (strips of rows, halo rows x0 - 1
    and x1, the unit ring, units of several rows written at a time, a
    pixel's channels split across its group, the zero pixel) equals
    ``slot_attention_ref`` within f32 rounding, every output pixel written
    once."""
    rng = np.random.default_rng(X * 100 + Y + C)
    xl, xr = (rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32) for _ in range(2))
    att = rng.normal(size=(H, C)).astype(np.float32)
    plan = plan or gf.fwd_plan(Bf, X, Y, H, C, 4, sms=1)
    strip, ytile, stages, group, rows = plan
    assert stages > gf.LIVE_UNITS and group == gf.channel_group(C)[1]
    assert gf.fwd_threads(ytile, H, group, rows) <= gf.FWD_THREADS and (rows == 1 or ytile >= Y)
    got, written = _slot_fwd_walk(xl, xr, att, H, C, plan)
    want = gf.slot_attention_ref(*(torch.from_numpy(a) for a in (xl, xr, att)), H, C).numpy()
    assert (written == 1).all()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), np.abs(got - want).max()


def test_slot_fwd_plan_fills_the_card_and_fits():
    """At the rollout's one frame (1, 240, 64) the plan gives at least 120
    blocks, at C 48 and C 3; at the training step's 80 frames 30-row strips
    of whole rows (640 blocks), in units of one row at C 48 (a row takes
    all 256 consumers) and of four at C 3.  For every (H, C) with H*C <= 256
    the wrapper takes, in bf16 and f32, the plan fits a block's shared
    memory, its rows fit the consumers, a thread takes at most 8 chunks (the
    kernel's widest template) and every region starts on 16 bytes."""
    for C in (48, 3):
        plan = gf.fwd_plan(1, 240, 64, 1, C, 2)
        assert gf.fwd_blocks(1, 240, 64, plan[0], plan[1]) >= 120
        strip, ytile, stages, _, rows = gf.fwd_plan(80, 240, 64, 1, C, 2)
        assert (strip, ytile, rows) == (gf.STRIP, 64, 1 if C == 48 else 4)
        assert gf.fwd_blocks(80, 240, 64, strip, ytile) == 640
        assert gf.fwd_smem(64, stages, 1, C, 2, rows) <= gf.SMEM_SHARED
    for H in range(1, 257):
        for C in range(1, 256 // H + 1):
            vec, group, chunks = gf.channel_group(C)
            assert chunks <= 8 and H * group <= gf.FWD_THREADS
            for Bf, Y, elem in ((200, 1, 2), (2, 64, 2), (200, 3, 4), (2, 64, 4)):
                strip, ytile, stages, g, rows = gf.fwd_plan(Bf, 7, Y, H, C, elem)
                assert g == group and 1 <= strip <= gf.STRIP and 1 <= rows <= strip
                assert stages > gf.LIVE_UNITS and 1 <= ytile <= Y and (rows == 1 or ytile == Y)
                smem = gf.fwd_smem(ytile, stages, H, C, elem, rows)
                assert smem <= gf.SMEM_MAX and smem % 16 == 0
                assert 32 <= gf.fwd_threads(ytile, H, g, rows) <= gf.FWD_THREADS


def test_slot_fwd_plan_is_the_kernels():
    """``FWD_THREADS`` and ``LIVE_UNITS`` are the forward kernel's own
    (``csrc/grid_slot_attention.cu``), and the kernel takes the chunk
    counts ``channel_group`` gives (templates of 3, 4 and 8)."""
    src = (Path(gf.__file__).parents[1] / "csrc" / "grid_slot_attention.cu").read_text()
    for name in ("FWD_THREADS", "LIVE_UNITS"):
        got = re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1)
        assert got == str(getattr(gf, name)), name
    assert re.findall(r"std::integral_constant<int, (\d+)>\{\}\);", src)[:3] == ["3", "4", "8"]


# -- the segment gather (ops/segment_ops.gather_plan)


def _gather_walk(M, F, vec, plan):
    """The gather kernel's warps walked in Python: for each warp, its tiles
    (grid-stride), each lane's vector slots in the order the kernel issues
    them (the column and edge advanced by 32 slots at a time, as the kernel
    does, held against the division), the id taken from the lane that
    loaded it.  Returns the times each (edge, vector) was written."""
    depth, warps, blocks = plan
    nv = F // vec
    hits = np.zeros((M, nv), int)
    n_warps = blocks * warps
    for w0 in range(n_warps):
        for tile in range(w0, so.gather_tiles(M, nv, depth), n_warps):
            if nv == 1:
                for lane in range(32):
                    for u in range(depth):
                        e = tile * 32 * depth + lane + 32 * u
                        if e < M:
                            hits[e, 0] += 1
                continue
            e0 = tile * 32
            n_e = min(32, M - e0)
            for lane in range(32):
                u, c = lane // nv, lane % nv
                for t0 in range(0, nv, depth):
                    for k in range(depth):
                        s = lane + 32 * (t0 + k)
                        if s < n_e * nv:
                            assert (u, c) == divmod(s, nv) and u < n_e  # the id's lane loaded it
                            hits[e0 + u, c] += 1
                        u, c = u + 32 // nv, c + 32 % nv
                        if c >= nv:
                            u, c = u + 1, c - nv
    return hits


@pytest.mark.parametrize("M,F,vec", [
    (1000, 128, 4), (1000, 132, 4), (1000, 3, 1), (1000, 2, 2), (1000, 1, 1), (33, 2, 1),
    (5, 128, 4), (70, 32, 4), (129, 4, 4), (300, 12, 2),
])
def test_gather_plan_walk_writes_every_edge_once(M, F, vec):
    """``gather_plan``'s grid, and grids that walk several tiles a warp,
    write every vector of every edge row exactly once."""
    for plan in (so.gather_plan(M, F, vec), (2, 1, 3), (so.GATHER_DEPTH, 2, 1)):
        assert (_gather_walk(M, F, vec, plan) == 1).all(), plan


def test_gather_plan_at_the_graph_shapes_and_is_the_kernels():
    """At MeshGraphNet's gathers (81 920 edge rows; F 128 in 16-byte
    vectors, F 2 in 8-byte ones) and GAT's (F 1) the plan takes one tile a
    warp; ``GATHER_DEPTH`` and the depths dispatched are the kernel's own
    (``csrc/segment_ops.cu``)."""
    for F, vec in ((128, 4), (2, 2), (1, 1)):
        depth, warps, blocks = so.gather_plan(81920, F, vec)
        assert depth in so.GATHER_DEPTHS and 1 <= warps <= 32
        assert blocks == -(-so.gather_tiles(81920, F // vec, depth) // warps)
    src = (Path(so.__file__).parents[1] / "csrc" / "segment_ops.cu").read_text()
    got = re.search(r"^constexpr int GATHER_DEPTH = (\d+);", src, re.M).group(1)
    assert got == str(so.GATHER_DEPTH)
    dispatched = re.findall(r"if \(depth == (\w+)\)", src)
    assert [so.GATHER_DEPTH if d == "GATHER_DEPTH" else int(d) for d in dispatched] == \
        list(so.GATHER_DEPTHS)


# -- the learned positions' add (ops/pos_embed.grad_plan)


@pytest.mark.parametrize("R,d,n_tab", [(42240, 768, 30), (21120, 1024, 30), (1204, 772, 30),
                                       (5000, 768, 1600), (5, 768, 30), (100, 6, 3),
                                       (42240, 767, 30)])
def test_pos_embed_grad_plan_covers_every_row_and_column_within_the_kernels_bounds(R, d, n_tab):
    """The chunks tile the rows and the slabs the vector columns, each
    once; a block's threads and shared memory are within the kernel's
    bounds (``WIDTH_MAX``, ``SMEM_MAX``); ``ID_TILE`` and ``SMEM_MAX`` are the
    kernel's own (``csrc/pos_embed.cu``); the grid fills 132 SMs where the
    rows allow."""
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    src = (Path(pe.__file__).parents[1] / "csrc" / "pos_embed.cu").read_text()
    const = {name: int(re.search(rf"^constexpr int {name} = (\d+);", src, re.M).group(1))
             for name in ("ID_TILE", "SMEM_MAX", "WIDTH_MAX")}
    assert (const["ID_TILE"], const["SMEM_MAX"]) == (pe.ID_TILE, pe.SMEM_MAX)
    for vec in (1, 4) if d % 4 == 0 else (1,):
        width, rows = pe.grad_plan(R, d, n_tab, vec, 132)
        nv, chunks = d // vec, -(-R // rows)
        slabs = -(-nv // width)
        assert 1 <= width <= min(pe.MAX_WIDTH, const["WIDTH_MAX"], nv)
        assert pe.grad_smem(n_tab, width, vec) <= pe.SMEM_MAX
        assert (chunks - 1) * rows < R <= chunks * rows and (slabs - 1) * width < nv <= slabs * width
        assert chunks * slabs >= min(132, -(-R // pe.MIN_CHUNK_ROWS) * slabs)
