"""The port's CUDA kernels against their plain twins, on the card.

Needs an NVIDIA GPU with ``nvcc``; every test here is marked ``cuda`` and
skips elsewhere.  This file imports no jax, so it runs on a machine without
it (the repository's ``conftest.py`` does import jax, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: relative L2 error <= 1e-2 in bf16.  The kernels keep scores,
softmax and sums in f32 and round once; the twins round intermediates to
bf16 (attention probabilities, GATv2 logits and weights), which alone gives
relative errors of a few 1e-3.  The same bound holds the gradients: the
flash backward rounds p and ds to bf16 once each as tensor-core operands
and its outputs once (each ~2^-9 relative); the backward twins compute in
f32 and round their outputs only.  Autograd through the Functions is held
against autograd through the forward twins on f32 copies of the inputs.
The slab decode kernel is held to the same bound in the streaming cache's
states (first decode, wrapped ring, prefill), and a short streaming
rollout through the kernels against the same rollout through the twins.
The int8 matmul kernels are held to the same bound at the serving shapes;
w8a8's int32 sum must equal its twin's exactly, and with it the output
(the same f32 scale products and roundings), under every launch plan
(column tile, K split), at phase 3's nine shapes with and without bias,
on a second call and from a CUDA graph.  The slot-attention backward
(strips of 30 rows, X and Y down to 1, F up to 256, unaligned inputs)
repeats bit for bit, also from a graph, and allocates no scratch beyond
its outputs and datt's partials; so does the forward at its plan's edge
cases (strips cut short, X and Y 1, column tiles, units of several rows,
C 3 and 5, F 255 and 256, unaligned inputs through plain copies).  The indexed linear is held
to the same bound at the stacked streaming step's five shapes, at the
first and the last layer of 12 (an off-by-one-layer offset would read
another layer's weights: relative error ~1.4); the short-attention kernel
at the training step's and the rollout's shapes, valid rows only (the
forced-diagonal rows are checked finite), and a short stacked streaming
rollout through the kernels against the twins.  The slab decode's key
splits (1, 2, 11 and 33 slots, bs 1, 2 and 4, wholly masked splits, rows
that see no key) and the indexed linear's K splits (K 128 to 11 008, M 1
to 661, strided x) are held to the same bound, and both must repeat bit for
bit, the decode also when replayed from a CUDA graph.  So are w8a16 under
every launch plan (token tile, K split; M 1 to 661, K 768 to 3072, a
partial tile of weight rows, x a slice of a fused projection, repeats and
graph replay) and short attention under both plans (64 or 128 query rows
a block; L 1 to 1536, hd 64 and 128, rows that see only their forced
diagonal, repeats), and the flash dq and dk/dv (L 1 to 1536, hd 32 to
128, diagonal-only rows, q/k/v slices of one fused projection), repeating
bit for bit, also in a graph; exact attention and the flash forward too
(their out and lse).  The segment sum equals a CPU walk of its CSR (each
row's edges ascending, added in f32 from 0) bit for bit at F 1, 2, 32 and
128, dropped ids and the 132-edge ghost row included, also from a graph;
the gather equals its twin bit for bit under every plan at F 1, 2, 3, 128
and 132, ids out of range and rows off 16 bytes included.  Both hold at
GraphViT's unsorted member ids (F 2, 32, 64, 512), and in bf16 (F 1, 32,
128, 512; the sum against the walk on the values in f32, rounded once);
a GraphViT train step in f32 and bf16 agrees with its twins and launches
what the code counts.  The learned positions' add (f32) equals its twin
bit for bit forward, at the training step's and the 350m rollout's shapes
and at its plan's edges (d off the slab, tables too long for a full-width
accumulator, fewer rows than a block has in flight, inputs off 16 bytes,
one-row tables); its backward equals the walk of its own order bit for
bit, lies within f32 rounding of the twin's ``index_put_`` sums, and
repeats bit for bit, also from a graph; dh is the incoming gradient.
A gradient that is zero in exact arithmetic (dq and dk of rows that see
only their diagonal) is held to rounding noise, 1e-4 of |dout|, instead.
"""

from unittest import mock

import pytest
import torch

from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa
from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
from fluid_llm_tpu_torch.ops import indexed_linear as il
from fluid_llm_tpu_torch.ops import pos_embed as pe
from fluid_llm_tpu_torch.ops import quant
from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.ops import short_attention as sa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("L,H,hd,n_invalid", [
    (661, 12, 64, 0), (661, 12, 64, 181), (300, 4, 32, 37), (300, 4, 128, 0), (5, 1, 64, 2),
])
def test_exact_attention_kernel_matches_twin(dev, L, H, hd, n_invalid):
    D = H * hd
    g = torch.Generator().manual_seed(L + hd)
    qkv = (torch.randn(1, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    valid = (torch.arange(L)[None] >= n_invalid).int().to(dev)
    before = xa.causal_attention.launches
    out = xa.causal_attention(q, k, v, valid, H, hd)
    torch.cuda.synchronize()
    assert xa.causal_attention.launches == before + 1
    assert _rel(out, xa.causal_attention_ref(q, k, v, valid, H, hd)) <= REL_TOL


def test_exact_attention_kernel_rejects_f32(dev):
    q = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(ValueError):
        xa.causal_attention(q, q, q, torch.ones(1, 8, dtype=torch.int32, device=dev), 1, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bf,X,Y,H,C", [
    (1, 240, 64, 1, 48), (1, 240, 64, 1, 3), (4, 240, 64, 2, 24), (2, 8, 8, 2, 4),
])
def test_slot_attention_kernel_matches_twin(dev, dtype, Bf, X, Y, H, C):
    g = torch.Generator().manual_seed(X + C)
    xl, xr = (torch.randn(Bf, X, Y, H * C, generator=g).to(dev, dtype) for _ in range(2))
    att = torch.randn(H, C, generator=g).to(dev, dtype)
    before = gf.fused_slot_attention.launches
    out = gf.fused_slot_attention(xl, xr, att, H, C)
    torch.cuda.synchronize()
    assert gf.fused_slot_attention.launches == before + 1
    tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
    assert _rel(out, gf.slot_attention_ref(xl, xr, att, H, C)) <= tol


# the forward's plan at its edge cases: (strip, ytile, stages, group, rows
# a unit), None for the wrapper's own plan
SLOT_FWD_CASES = [
    (80, 240, 64, 1, 48, None), (1, 240, 64, 1, 48, None), (80, 240, 64, 1, 3, None),
    (1, 240, 64, 1, 3, None),
    (2, 5, 6, 1, 3, (8, 6, 4, 1, 4)),  # X < strip; C 3; units of 4 rows, the last short
    (2, 37, 5, 2, 24, (30, 5, 5, 2, 1)),  # X not a multiple of the strip; H 2
    (1, 1, 4, 1, 8, (30, 4, 4, 1, 1)), (1, 1, 4, 1, 8, (30, 4, 4, 1, 2)),  # X 1
    (1, 33, 1, 1, 4, (4, 1, 6, 1, 3)),  # Y 1; units of 3 rows
    (1, 20, 7, 1, 48, (3, 3, 4, 4, 1)),  # column tiles of 3, the shortest ring
    (1, 33, 6, 2, 5, (7, 6, 5, 2, 2)),  # C 5: chunks of one channel; units of 2 rows
    (2, 20, 8, 1, 3, (9, 8, 4, 1, 5)),  # units of 5 rows, strips of 9
    (80, 240, 64, 1, 3, (8, 64, 6, 1, 2)), (80, 240, 64, 1, 48, (15, 64, 4, 4, 1)),
    (1, 20, 64, 1, 256, None), (1, 9, 64, 16, 16, None), (2, 9, 64, 1, 255, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bf,X,Y,H,C,plan", SLOT_FWD_CASES)
def test_slot_attention_fwd_plans_repeat_bit_for_bit_also_in_a_graph(dev, dtype, Bf, X, Y, H, C,
                                                                     plan):
    """The forward's strip walk at the main path's shapes and at the plan's
    edge cases (strips cut short, X 1, Y 1, column tiles, units of several
    rows, C 3 and 5, H 2 and 16, F 255 and 256): within the bound of the
    twin, the same bits on a second call and when replayed from a CUDA graph
    (no atomics)."""
    g = torch.Generator().manual_seed(X + C)
    xl, xr = (torch.randn(Bf, X, Y, H * C, generator=g).to(dev, dtype) for _ in range(2))
    att = torch.randn(H, C, generator=g).to(dev, dtype)
    fixed = plan or gf.fwd_plan(Bf, X, Y, H, C, xl.element_size())
    with mock.patch.object(gf, "fwd_plan", lambda *a: fixed):
        before = gf.fused_slot_attention.launches
        out = gf.fused_slot_attention(xl, xr, att, H, C)
        again = gf.fused_slot_attention(xl, xr, att, H, C)
        torch.cuda.synchronize()
        assert gf.fused_slot_attention.launches == before + 2
        assert torch.equal(out, again)
        tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
        assert _rel(out, gf.slot_attention_ref(xl, xr, att, H, C)) <= tol
        for replayed in _graph_replays(lambda: gf.fused_slot_attention(xl, xr, att, H, C)):
            assert torch.equal(replayed, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [48, 3])
def test_slot_attention_fwd_unaligned_inputs_take_plain_copies(dev, dtype, C):
    """Inputs that do not start on 16 bytes (contiguous views at an offset
    of one element) are copied by the producer warp's lanes instead of TMA
    bulk copies: the same result bit for bit."""
    g = torch.Generator().manual_seed(6)
    shape = (4, 40, 64, C)
    xl, xr = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(2))
    att = torch.randn(1, C, generator=g).to(dev, dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        view = buf[1:].view(shape)
        view.copy_(t)
        return view

    want = gf.fused_slot_attention(xl, xr, att, 1, C)
    got = gf.fused_slot_attention(shifted(xl), shifted(xr), att, 1, C)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _flash_case(dev, bs, L, H, hd, n_invalid, fused):
    """q, k, v (column slices of one fused projection where ``fused``), dout
    and the validity with the first ``n_invalid`` keys invalid."""
    D = H * hd
    g = torch.Generator().manual_seed(L + hd)
    if fused:
        qkv = (torch.randn(bs, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    else:
        q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                   for _ in range(3))
    dout = torch.randn(bs, L, D, generator=g).to(dev, torch.bfloat16)
    valid = (torch.arange(L)[None] >= n_invalid).expand(bs, L).int().contiguous().to(dev)
    return q, k, v, dout, valid


@pytest.mark.parametrize("bs,L,H,hd,n_invalid,fused", [
    (8, 601, 12, 64, 0, False), (8, 601, 12, 64, 181, False), (2, 70, 2, 32, 13, False),
    (1, 300, 4, 128, 37, False), (1, 5, 1, 64, 2, False),
    (1, 1, 2, 64, 0, True), (2, 63, 2, 32, 5, True), (1, 64, 2, 128, 0, False),
    (2, 65, 3, 64, 1, True), (1, 128, 2, 64, 0, True), (2, 129, 2, 128, 3, True),
    (1, 130, 3, 64, 64, True), (1, 601, 2, 128, 420, True), (1, 601, 4, 32, 0, True),
    (1, 1536, 2, 64, 37, True), (1, 1536, 1, 128, 0, False),
])
def test_flash_kernels_match_twins(dev, bs, L, H, hd, n_invalid, fused):
    """Forward (out, lse) and backward (dq, dk, dv from the kernel's saved
    state) at the training shape and odd ones: L 1 to 1536 (tails past a
    64-row tile), every head width, invalid front tokens (whose query rows
    see only their forced diagonal; every row but one of a tile at 64),
    q/k/v column slices of one fused projection."""
    q, k, v, dout, valid = _flash_case(dev, bs, L, H, hd, n_invalid, fused)
    before = (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, valid, H, hd)
    grads = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == \
        tuple(n + 1 for n in before)
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, valid, H, hd)
    assert _rel(out, ref_out) <= REL_TOL
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    want = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
    for got, w in zip(grads, want):
        assert bool(torch.isfinite(got).all())
        _assert_grad_close(got, w, dout)


def _assert_grad_close(got, want, dout, note=None):
    """Within REL_TOL of the twin; a gradient that is zero in exact
    arithmetic (dq and dk where every row sees only its forced diagonal:
    ds_ii = dp_ii - delta_i = 0 there) holds both sides to rounding noise,
    1e-4 of |dout|, where a relative error means nothing."""
    scale = 1e-4 * dout.float().norm()
    if want.float().norm() <= scale:
        assert got.float().norm() <= scale, note
    else:
        assert _rel(got, want) <= REL_TOL, note


def _graph_replays(fn, n: int = 2):
    """``fn``'s outputs from a CUDA graph that captured one call, replayed
    ``n`` times: a generator of the same output tensors after each replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    for _ in range(n):
        graph.replay()
        torch.cuda.synchronize()
        yield replayed


@pytest.mark.parametrize("bs,L,H,hd", [(8, 601, 12, 64), (2, 129, 2, 128), (1, 70, 3, 32)])
def test_flash_backward_repeats_bit_for_bit_also_in_a_graph(dev, bs, L, H, hd):
    """dq, dk and dv equal bit for bit on a second call and when replayed
    from a CUDA graph (no atomics; every element written by one block)."""
    q, k, v, dout, valid = _flash_case(dev, bs, L, H, hd, 5, True)
    out, lse = fa.flash_forward(q, k, v, valid, H, hd)
    first = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
    again = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for replayed in _graph_replays(
            lambda: fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)):
        for a, b in zip(first, replayed):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bs,L,H,hd", [(1, 661, 12, 64), (8, 601, 12, 64), (2, 129, 2, 128),
                                       (1, 70, 3, 32)])
def test_exact_and_flash_forward_repeat_bit_for_bit_also_in_a_graph(dev, bs, L, H, hd):
    """The exact kernel's output and the flash forward's (out, lse) equal bit
    for bit on a second call and when replayed from a CUDA graph (no
    atomics; every element written once by one block)."""
    q, k, v, _, valid = _flash_case(dev, bs, L, H, hd, 5, True)

    def calls():
        out = xa.causal_attention(q, k, v, valid, H, hd)
        return (out,) + fa.flash_forward(q, k, v, valid, H, hd)

    first, again = calls(), calls()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for replayed in _graph_replays(calls):
        for a, b in zip(first, replayed):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bf,X,Y,H,C", [
    (80, 240, 64, 1, 48), (80, 240, 64, 1, 3), (4, 240, 64, 2, 24), (2, 8, 8, 2, 4),
    (3, 37, 5, 2, 24), (2, 1, 6, 1, 48), (2, 2, 3, 1, 48), (1, 33, 1, 1, 4),
    (1, 20, 64, 1, 256), (1, 9, 64, 16, 16), (2, 5, 7, 1, 5),
])
def test_slot_attention_bwd_kernel_matches_twin(dev, dtype, Bf, X, Y, H, C):
    """dxl, dxr, datt at the training decoder's shapes (80 frames), strips
    cut short (X 37, 33, 1, 2: not a multiple of the 30 rows a block owns,
    or fewer), Y 1, F 256 (column tiles in f32) and chunks of one channel (C
    3, 5): within the bound of the twin, the same bit for bit on a second
    call and when replayed from a CUDA graph (no atomics); no alpha/dlogit
    scratch: the call allocates its outputs and one row of datt partials a
    block."""
    g = torch.Generator().manual_seed(X + C)
    xl, xr, dout = (torch.randn(Bf, X, Y, H * C, generator=g).to(dev, dtype) for _ in range(3))
    att = torch.randn(H, C, generator=g).to(dev, dtype)
    before = gf.slot_attention_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = gf.slot_attention_bwd(xl, xr, att, dout, H, C)
    torch.cuda.synchronize()
    ytile = gf.bwd_plan(Y, H, C, xl.element_size())[0]
    partial = gf.bwd_blocks(Bf, X, Y, ytile) * H * C * 4
    # the allocator rounds each large block up to 2 MiB: three allocations here
    assert torch.cuda.max_memory_allocated() - held <= 2 * xl.nbytes + partial + 3 * 2**21
    again = gf.slot_attention_bwd(xl, xr, att, dout, H, C)
    torch.cuda.synchronize()
    assert gf.slot_attention_bwd.launches == before + 2
    tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
    for a, b, w in zip(got, again, gf.slot_attention_bwd_ref(xl, xr, att, dout, H, C)):
        assert torch.equal(a, b)
        assert _rel(a, w) <= tol
    for replayed in _graph_replays(lambda: gf.slot_attention_bwd(xl, xr, att, dout, H, C)):
        for a, b in zip(got, replayed):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slot_attention_bwd_unaligned_inputs_take_plain_copies(dev, dtype):
    """Inputs that do not start on 16 bytes (contiguous views at an offset
    of one element) are copied by the producer warp's lanes instead of TMA
    bulk copies: the same result bit for bit."""
    g = torch.Generator().manual_seed(5)
    shape = (4, 40, 64, 48)
    xl, xr, dout = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
    att = torch.randn(1, 48, generator=g).to(dev, dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        view = buf[1:].view(shape)
        view.copy_(t)
        return view

    want = gf.slot_attention_bwd(xl, xr, att, dout, 1, 48)
    got = gf.slot_attention_bwd(shifted(xl), shifted(xr), att, shifted(dout), 1, 48)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_exact_kernels_raise_under_autograd(dev):
    """The forward-only kernels refuse inputs that need a gradient when
    grad is enabled (the gradient would stop there silently); under
    no_grad, or on inputs without grad, they run."""
    q = torch.randn(1, 70, 128, device=dev, dtype=torch.bfloat16, requires_grad=True)
    valid = torch.ones(1, 70, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="forward only"):
        xa.causal_attention(q, q, q, valid, 2, 64)
    xl = torch.randn(1, 8, 8, 8, device=dev, requires_grad=True)
    att = torch.randn(1, 8, device=dev)
    with pytest.raises(RuntimeError, match="forward only"):
        gf.fused_slot_attention(xl, xl, att, 1, 8)
    with torch.no_grad():
        xa.causal_attention(q, q, q, valid, 2, 64)
        gf.fused_slot_attention(xl, xl, att, 1, 8)
    xa.causal_attention(q.detach(), q.detach(), q.detach(), valid, 2, 64)


def test_functions_match_autograd_through_twins(dev):
    """Gradients through ``FlashAttention`` and ``SlotAttention`` (their
    kernels) against autograd through the forward twins run in f32 on the
    same bf16 inputs."""
    g = torch.Generator().manual_seed(7)
    bs, L, H, hd = 2, 130, 4, 64
    base = [(torch.randn(bs, L, H * hd, generator=g) * 0.5).to(dev, torch.bfloat16)
            for _ in range(3)]
    valid = (torch.arange(L)[None] >= torch.tensor([[0], [40]])).int().contiguous().to(dev)
    w = torch.randn(bs, L, H * hd, generator=g).to(dev)
    ts = [t.clone().requires_grad_() for t in base]
    (fa.flash_attention(*ts, valid, H, hd).float() * w).sum().backward()
    refs = [t.float().requires_grad_() for t in base]
    (fa.flash_forward_ref(*refs, valid, H, hd)[0] * w).sum().backward()
    for t, r in zip(ts, refs):
        assert _rel(t.grad, r.grad) <= REL_TOL

    xs = [torch.randn(80, 240, 64, 48, generator=g).to(dev, torch.bfloat16) for _ in range(2)]
    att = torch.randn(1, 48, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(80, 240, 64, 48, generator=g).to(dev)
    ts = [t.clone().requires_grad_() for t in (*xs, att)]
    (gf.slot_attention(*ts, 1, 48).float() * w).sum().backward()
    refs = [t.float().requires_grad_() for t in (*xs, att)]
    (gf.slot_attention_ref(*refs, 1, 48) * w).sum().backward()
    for t, r in zip(ts, refs):
        assert _rel(t.grad, r.grad) <= REL_TOL


@pytest.mark.parametrize("mode", ["autoreg", "gen"])
def test_train_steps_on_card(dev, mode):
    """A small bf16 model (2 layers, hd 64, DoRA, dropout on, MLPGNN) takes
    two train steps of each mode on the card: the loss is finite, every
    training kernel launched, and ``gen``'s guide rollout (no grad) ran
    through the forward-only kernels."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.train.trainer import Trainer

    cfg = Config(llm_backbone="gpt2", llm_layers=2, half_precision=True, batch_size=2,
                 autoreg_seq_len=5, resolution=64, flash_attention=True,
                 lora_config={"r": 4, "lora_alpha": 16, "use_dora": True},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=5, mode="valid")
    model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(model.to(dev))
    batch = next(make_batches(ds, 2, shuffle=False, device=dev))
    counters = (fa.flash_forward, fa.flash_dq, fa.flash_dkv, gf.fused_slot_attention,
                gf.slot_attention_bwd, xa.causal_attention, pe.pos_embed_fwd, pe.pos_embed_grad)
    before = [fn.launches for fn in counters]
    losses = [trainer.train_step(batch, mode)["loss"].item() for _ in range(2)]
    torch.cuda.synchronize()
    ran = [fn.launches - b for fn, b in zip(counters, before)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert ran[:3] == [4, 4, 4] and ran[4] == 4  # 2 layers, 2 convs, 2 steps
    # gen: 3-step guide rollouts through the exact kernel (layer 0 of 2)
    assert ran[5] == (6 if mode == "gen" else 0)
    # the learned positions: a forward and a backward a step, and gen's
    # guide rollouts' 3 forwards
    assert ran[6:] == [8 if mode == "gen" else 2, 2]


@pytest.mark.parametrize("remat", [False, True])
def test_notf_step_on_card(dev, remat):
    """A ``notf`` step of a small bf16 model (2 layers, hd 64, MLPGNN with 2
    convs, batch 2, a 4-step rollout differentiated end to end): per rollout
    step the full layer's flash forward (twice with ``parallel.remat``: the
    step is recomputed in the backward), dq and dk/dv once, the slot forward
    at each conv (twice with remat) and its backward once; the exact kernel
    never.  Loss through the kernels within REL_TOL of the twins', each
    trainable leaf's gradient within 5e-2 relative L2 (four chained bf16
    steps), the ``att`` leaves included."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.train.trainer import Trainer

    cfg = Config(llm_backbone="gpt2", llm_layers=2, half_precision=True, batch_size=2,
                 autoreg_seq_len=5, resolution=64, flash_attention=True,
                 lora_config={"r": 4, "lora_alpha": 16, "use_dora": True},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32},
                 parallel={"remat": remat})
    ds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=5, mode="valid")
    model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(model.to(dev))
    batch = next(make_batches(ds, 2, shuffle=False, device=dev))
    counters = (fa.flash_forward, fa.flash_dq, fa.flash_dkv, gf.fused_slot_attention,
                gf.slot_attention_bwd, xa.causal_attention)
    res = {}
    for kernels in (True, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        before = [fn.launches for fn in counters]
        loss, _ = trainer.mode_loss(batch, "notf")
        loss.backward()
        torch.cuda.synchronize()
        ran = [fn.launches - b for fn, b in zip(counters, before)]
        res[kernels] = (loss.item(), {n: p.grad.float().flatten() for n, p in
                                      model.named_parameters() if p.requires_grad})
        fwd = 2 if remat else 1
        assert ran == ([fwd * 4, 4, 4, fwd * 2 * 4, 2 * 4, 0] if kernels else [0] * 6), ran
    model.kernels = True
    assert abs(res[True][0] - res[False][0]) <= REL_TOL * abs(res[False][0])
    leaf_rel = {n: _rel(g, res[False][1][n]) for n, g in res[True][1].items()}
    assert any(n.endswith(".att") for n in leaf_rel)
    assert all(torch.isfinite(g).all() for g in res[True][1].values())
    assert max(leaf_rel.values()) <= 5e-2, sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:4]


def _slab_case(dev, state: str, H: int = 12, hd: int = 64, bs: int = 1, R: int = 10,
               n_sink: int = 61, frame: int = 60):
    """A random bf16 slab cache of 3 layers in one streaming state, its
    key-position row, and queries as a column slice of a fused projection.
    ``first``: the first decode (ring slot 0 and the sinks written);
    ``wrapped``: R + 4 frames written, slot order != position order;
    ``prefill``: the sinks querying themselves (every ring slot unwritten,
    masked slabs before the only visible one); ``prefill_frame``: sinks and
    one frame, so the first query tile meets a slab only some rows see."""
    cfg = bb.BackboneConfig(family="llama", n_layers=3, d_model=H * hd, n_heads=H, d_ff=64,
                            norm="rmsnorm", pos="rope", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(len(state) + hd)
    cache = bb.init_streaming_cache(cfg, bs, n_sink, R, frame, device=dev)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g))
    base = lambda f: n_sink + f * frame  # noqa: E731
    ring = [-1] * R
    if state in ("first", "prefill_frame"):
        ring[0] = base(0)
    elif state == "wrapped":
        for f in range(R + 4):
            ring[f % R] = base(f)
    q0, P = {"first": (base(0), frame), "wrapped": (base(R + 3), frame),
             "prefill": (0, n_sink), "prefill_frame": (0, n_sink + frame)}[state]
    cache["ring_pos"].copy_(torch.tensor(ring, dtype=torch.int32))
    cache["sink_pos"].copy_(torch.arange(n_sink, dtype=torch.int32))
    key_pos = da.pad_key_pos(bb.slab_key_positions(cache, frame))
    D = H * hd
    q = (torch.randn(bs, P, 3 * D, generator=g)).to(dev, torch.bfloat16)[..., :D]
    return q, cache, key_pos, torch.tensor([q0], dtype=torch.int32, device=dev)


def _slab_call(q, cache, key_pos, q0, hd):
    return da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, 1, hd)


@pytest.mark.parametrize("state,H,hd,bs,slots", [
    ("first", 12, 64, 1, 11), ("wrapped", 12, 64, 1, 11), ("prefill", 12, 64, 1, 11),
    ("prefill_frame", 12, 64, 1, 11), ("wrapped", 4, 32, 2, 11), ("first", 4, 128, 2, 11),
    ("prefill", 12, 64, 1, 1), ("wrapped", 12, 64, 1, 2), ("first", 12, 64, 4, 2),
    ("wrapped", 12, 64, 2, 11), ("wrapped", 12, 64, 4, 11), ("wrapped", 12, 64, 1, 33),
    ("prefill", 12, 64, 2, 33), ("first", 12, 64, 4, 33),
])
def test_slab_decode_kernel_matches_twin(dev, state, H, hd, bs, slots):
    """The flagship's streaming shapes (slots of 64 rows, 60-token frames,
    61 sinks) read at layer 1 of 3, other head widths, and the key splits:
    one split (1 slot), one tile a split (11 slots, bs 1: 132 blocks at H
    12), several tiles a split with the next tile prefetched (33 slots; 11
    at bs 2 and 4), splits every key of which is masked (first decode,
    prefill): no NaN, one launch per call."""
    q, cache, key_pos, q0 = _slab_case(dev, state, H, hd, bs, R=slots - 1)
    n_splits, split_keys = da.split_plan(slots * 64, H, -(-q.shape[1] // 64), bs)
    assert (n_splits == 1) == (slots == 1)
    if H == 12 and (slots == 33 or (slots == 11 and bs > 1)):
        assert split_keys > 64  # a run of several tiles: the prefetch path
    before = da.slab_decode.launches
    out = _slab_call(q, cache, key_pos, q0, hd)
    torch.cuda.synchronize()
    assert da.slab_decode.launches == before + 1
    assert bool(torch.isfinite(out).all())
    ref = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, 1, hd)
    assert _rel(out, ref) <= REL_TOL


def test_slab_decode_kernel_raises_under_autograd(dev):
    q, cache, key_pos, q0 = _slab_case(dev, "first")
    q = q.detach().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, 1, 64)
    with torch.no_grad():
        da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, 1, 64)
    with pytest.raises(ValueError):
        da.slab_decode(q.detach().float(), cache["k"], cache["v"], key_pos, q0, 1, 64)


@pytest.mark.parametrize("slots", [1, 11])
def test_slab_decode_row_that_sees_no_key_is_zero(dev, slots):
    """Keys at positions q0 + 10 .. q0 + 59: query rows 0..9 see none and
    are written as zeros (one split, and the combine of 11); the other rows
    agree with the twin."""
    q, cache, key_pos, q0 = _slab_case(dev, "prefill" if slots == 1 else "wrapped", R=slots - 1)
    n = slots * 64
    key_pos = (int(q0) + 10 + torch.arange(n, dtype=torch.int32) % 50)[None].to(dev)
    out = _slab_call(q, cache, key_pos, q0, 64)
    ref = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, 1, 64)
    torch.cuda.synchronize()
    assert bool((out[:, :10] == 0).all())
    assert _rel(out[:, 10:], ref[:, 10:]) <= REL_TOL


@pytest.mark.parametrize("slots,bs", [(11, 1), (33, 4)])
def test_slab_decode_repeats_bit_for_bit_also_in_a_graph(dev, slots, bs):
    """Two calls give equal bits (the combine sums the splits in split
    order); two calls captured in one CUDA graph and replayed twice give
    the same bits again (the combine's counters reset themselves)."""
    q, cache, key_pos, q0 = _slab_case(dev, "wrapped", bs=bs, R=slots - 1)
    first, second = _slab_call(q, cache, key_pos, q0, 64), _slab_call(q, cache, key_pos, q0, 64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _slab_call(q, cache, key_pos, q0, 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = _slab_call(q, cache, key_pos, q0, 64)
        b = _slab_call(q, cache, key_pos, q0, 64)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, first) and torch.equal(b, first)
    assert torch.equal(first, second)


def test_streaming_rollout_kernels_match_twins(dev):
    """A small bf16 flagship-shaped model (LLaMA 2 layers of 2 heads of 64,
    rope_abs, absolute time, MLPGNN) streams 12 steps from one context
    state (the ring of 5 wraps), through the kernels and through the twins:
    every decode-attention launch counted (2 per step, 2 for the prefill),
    no exact-window launch, step 1 within REL_TOL."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming

    cfg = Config(llm_backbone="fluid/llama-125m", llm_layers=2, half_precision=True,
                 autoreg_seq_len=5, resolution=64, absolute_time_ids=True,
                 pos_embedding_params={"pos_embedding_type": "rope_abs"},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=5, mode="valid",
                                  absolute_time=True)
    model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).prepare_inference_params()
    states, _, _, bc_mask, pos = next(make_batches(ds, 1, shuffle=False, device=dev))
    out = {}
    for kernels in (True, False):
        model.kernels = kernels
        before = (da.slab_decode.launches, xa.causal_attention.launches)
        out[kernels] = generate_streaming(model, states[:, :1], bc_mask, pos, 12)[1]
        torch.cuda.synchronize()
        ran = (da.slab_decode.launches - before[0], xa.causal_attention.launches - before[1])
        assert ran == ((2 * 12 + 2, 0) if kernels else (0, 0))
    assert bool(torch.isfinite(out[True]).all())
    assert _rel(out[True][:, 0], out[False][:, 0]) <= REL_TOL


def _qmm_case(dev, M, K, N, bias: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed + M + K + N)
    qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
    x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    b = (torch.randn(N, generator=g) * 0.1).to(dev) if bias else None
    return x, qp["q"].to(dev), qp["scale"].to(dev), b


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("M,K,N,bias", [
    (60, 768, 768, False), (60, 768, 2048, False), (60, 2048, 768, False),
    (661, 768, 768, True), (661, 768, 3072, True), (661, 3072, 768, True),
    (61, 768, 2048, False), (5, 768, 3072, True),
    (60, 768, 3072, True), (60, 3072, 768, True),
    (1, 768, 768, True), (1, 3072, 768, False), (64, 2048, 768, False), (64, 768, 3072, True),
    (65, 3072, 768, True), (65, 768, 2048, False), (61, 3072, 768, True),
    (661, 2048, 768, False), (60, 768, 80, True), (60, 11008, 4096, False),
    (4808, 768, 768, True), (4808, 768, 3072, True), (4808, 3072, 768, True),
])
def test_quant_matmul_kernels_match_twins(dev, mode, M, K, N, bias):
    """The streaming step's (60 rows; 61 in the prefill), the exact
    rollout's (661; 60 in its sliced last block, with OPT's biases), the
    train step's over an int8 frozen backbone (8 x 601 rows), M 1,
    64, 65 and a ragged 5 rows, K 768 to 3072, N 80 (a partial tile of
    weight rows in w8a16): one launch, finite, within REL_TOL of the twin;
    w8a8 equal to it.  w8a16 also under every launch plan
    (``quant_matmul.plans``: token tile, K split), and repeated bit for bit,
    also when replayed from a CUDA graph."""
    x, q, scale, b = _qmm_case(dev, M, K, N, bias)
    fn = qmm.qmm_w8a8 if mode == "w8a8" else qmm.qmm_w8a16
    before = fn.launches
    out = qmm.int8_matmul(x, q, scale, b, mode)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = qmm.int8_matmul_ref(x, q, scale, b, mode)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= REL_TOL
    if mode == "w8a8":
        assert torch.equal(out, ref)
    assert torch.equal(qmm.int8_matmul(x, q, scale, b, mode), out)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = qmm.int8_matmul(x, q, scale, b, mode)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)
    if mode == "w8a8":
        for _, *p in qmm.w8a8_plans(M, K, N):
            with mock.patch.object(qmm, "w8a8_plan", lambda *a, p=tuple(p): p):
                assert torch.equal(qmm.int8_matmul(x, q, scale, b, mode), ref), p
        return
    for _, *p in qmm.plans(M, K, N):
        with mock.patch.object(qmm, "plan", lambda *a, p=tuple(p): p):
            got = qmm.int8_matmul(x, q, scale, b, mode)
        assert _rel(got, ref) <= REL_TOL, p


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (60, 61)
                                   for K, N in ((768, 768), (768, 2048), (2048, 768))]
                         + [(661, 768, 768), (661, 768, 3072), (661, 3072, 768)])
def test_quant_matmul_w8a8_is_its_twin_bit_for_bit_at_phase_3_shapes(dev, M, K, N, bias):
    """At chip_smoke phase 3's nine w8a8 shapes, with and without bias: the
    kernel's output equals the twin's bit for bit (exact int32 sums, the
    same row maxima, division, roundings and scale products), on a second
    call and from a CUDA graph too."""
    x, q, scale, b = _qmm_case(dev, M, K, N, bias, seed=1)
    ref = qmm.int8_matmul_ref(x, q, scale, b, "w8a8")
    out = qmm.qmm_w8a8(x, q, scale, b)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(qmm.qmm_w8a8(x, q, scale, b), out)
    for replayed in _graph_replays(lambda: qmm.qmm_w8a8(x, q, scale, b)):
        assert torch.equal(replayed, out)


def test_quant_matmul_w8a8_rounds_ties_like_its_twin(dev):
    """Activations on the int8 grid's half points (every row's absmax 127,
    so x / sx lands exactly on k + 0.5) round half to even, as the twin's
    ``torch.round``: the kernel's reciprocal shortcut must defer to the
    division there."""
    x = (torch.arange(60 * 768) % 254 - 126.5).reshape(60, 768)
    x[:, 0] = 127.0
    x = x.to(dev, torch.bfloat16)
    _, q, scale, _ = _qmm_case(dev, 60, 768, 768, False)
    assert torch.equal(qmm.int8_matmul(x, q, scale, mode="w8a8"),
                       qmm.int8_matmul_ref(x, q, scale, mode="w8a8"))


@pytest.mark.parametrize("M", [60, 661])
def test_quant_matmul_leading_axes_and_row_stride(dev, M):
    """(bs, L, K) input, a column slice of a wider tensor (row stride !=
    K) and the middle third of a fused (M, 3K) projection: each gives the
    contiguous 2-D result."""
    x, q, scale, _ = _qmm_case(dev, M, 768, 768, False)
    wide = torch.cat([x, x], dim=1)[:, :768]
    fused = torch.cat([x.flip(0), x, x.flip(1)], dim=1)[:, 768:1536]
    for mode in qmm.QMM_MODES:
        flat = qmm.int8_matmul(x, q, scale, mode=mode)
        lead = (2, M // 2) if M % 2 == 0 else (1, M)
        assert torch.equal(qmm.int8_matmul(x.reshape(*lead, 768), q, scale, mode=mode),
                           flat.reshape(*lead, 768))
        assert torch.equal(qmm.int8_matmul(wide, q, scale, mode=mode), flat)
        assert torch.equal(qmm.int8_matmul(fused, q, scale, mode=mode), flat)


def test_quant_matmul_raises(dev):
    """Under autograd the kernel runs as ``Int8Matmul``'s forward (launched
    and counted, the same output bit for bit) and dx is ``g @ (q s)`` in
    bf16; a shape ``supported`` refuses, f32 activations and bf16 scales
    raise in the wrapper, nothing falls back."""
    x, q, scale, _ = _qmm_case(dev, 60, 768, 768, False)
    xg = x.detach().requires_grad_()
    g = torch.randn(60, 768, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).bfloat16()
    for mode in ("w8a8", "w8a16"):
        counter = qmm.qmm_w8a8 if mode == "w8a8" else qmm.qmm_w8a16
        before = counter.launches
        out = qmm.int8_matmul(xg, q, scale, mode=mode)
        assert counter.launches == before + 1
        with torch.no_grad():
            assert torch.equal(qmm.int8_matmul(xg, q, scale, mode=mode), out)
        (dx,) = torch.autograd.grad(out, xg, g)
        assert torch.equal(dx, g @ quant.dequantize_weight(q, scale, torch.bfloat16))
        with pytest.raises(ValueError, match="not supported"):
            qmm.int8_matmul(x[:, :100], q[:, :100].contiguous(), scale, mode=mode)
        with pytest.raises(ValueError, match="bf16"):
            qmm.int8_matmul(x.float(), q, scale, mode=mode)
        with pytest.raises(ValueError, match="f32"):
            qmm.int8_matmul(x, q, scale.bfloat16(), mode=mode)


def test_cast_matmul_params_keeps_quantized_scales_f32(dev):
    """On the card, ``prepare_inference_params`` with int8 storage: q/k/v
    stay unpacked, scales and biases f32, float linears bf16."""
    cfg = bb.BackboneConfig(family="opt", n_layers=2, d_model=128, n_heads=2, d_ff=256,
                            pos_offset=2, dtype=torch.bfloat16)
    model = bb.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    quant.quantize_backbone(model, "int8")
    model.layers[1].mlp["fc2"] = torch.nn.Linear(256, 128, device=dev)  # one stays float
    bb.pack_qkv_params(model)
    bb.cast_matmul_params(model, torch.bfloat16)
    for layer in model.layers:
        assert "qkv" not in layer.attn
        for lin in list(layer.attn.values()) + [layer.mlp["fc1"]]:
            assert lin.scale.dtype == torch.float32 and lin.bias.dtype == torch.float32
            assert lin.q.device.type == "cuda"
    assert model.layers[1].mlp["fc2"].weight.dtype == torch.bfloat16


def test_quantized_streaming_rollout_kernels_match_twins(dev):
    """A small bf16 flagship-shaped model stored as int8 streams 6 steps
    through the kernels and through the twins: every int8 linear of every
    step and of the prefill launches the w8a8 kernel (7 a layer), step 1
    within REL_TOL."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming

    cfg = Config(llm_backbone="fluid/llama-125m", llm_layers=2, half_precision=True,
                 autoreg_seq_len=5, resolution=64, absolute_time_ids=True,
                 pos_embedding_params={"pos_embedding_type": "rope_abs"},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=5, mode="valid",
                                  absolute_time=True)
    model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).prepare_inference_params("int8", "w8a8")
    states, _, _, bc_mask, pos = next(make_batches(ds, 1, shuffle=False, device=dev))
    out = {}
    for kernels in (True, False):
        model.kernels = kernels
        before = (qmm.qmm_w8a8.launches, qmm.qmm_w8a16.launches)
        out[kernels] = generate_streaming(model, states[:, :1], bc_mask, pos, 6)[1]
        torch.cuda.synchronize()
        ran = (qmm.qmm_w8a8.launches - before[0], qmm.qmm_w8a16.launches - before[1])
        assert ran == ((7 * 2 * 7, 0) if kernels else (0, 0))
    assert bool(torch.isfinite(out[True]).all())
    assert _rel(out[True][:, 0], out[False][:, 0]) <= REL_TOL


def test_moe_rollout_kernels_match_twins(dev):
    """A small bf16 MoE model (OPT layout, 2 layers, 4 experts, top-2, cf
    1.25) rolls out 4 steps through the kernels and the twins: its final
    block runs whole, so exact attention launches 2 a step (every layer),
    and int8 storage adds 4 w8a16 launches a layer (the banks are
    dequantised); step 1 within REL_TOL."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.rollout.generate import generate

    cfg = Config(llm_layers=2, half_precision=True, use_lora=False, autoreg_seq_len=5,
                 resolution=64, moe={"experts": 4, "top_k": 2, "capacity_factor": 1.25},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=5, mode="valid")
    states, _, _, bc_mask, pos = next(make_batches(ds, 1, shuffle=False, device=dev))
    for quant_mode in (None, "int8"):
        model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
        model.init_weights(torch.Generator().manual_seed(0))
        model.to(dev).prepare_inference_params(quant_mode)
        out = {}
        for kernels in (True, False):
            model.kernels = kernels
            before = (xa.causal_attention.launches, qmm.qmm_w8a16.launches)
            out[kernels] = generate(model, states[:, :1], bc_mask, pos, 4)[1]
            torch.cuda.synchronize()
            ran = (xa.causal_attention.launches - before[0], qmm.qmm_w8a16.launches - before[1])
            want = (2 * 4, 4 * 2 * 4 if quant_mode else 0) if kernels else (0, 0)
            assert ran == want, (quant_mode, ran, want)
        assert bool(torch.isfinite(out[True]).all())
        assert _rel(out[True][:, 0], out[False][:, 0]) <= REL_TOL


def test_stacked_int8_streaming_equals_unrolled(dev):
    """The stacked layout of int8 layers streams bit for bit as the
    unrolled one on the card: each layer's int8 linears launch the w8a16
    kernel on its slice of the stacked storage (the same bytes), the
    indexed linear never."""
    cfg = bb.BackboneConfig(family="llama", n_layers=3, d_model=256, n_heads=4, d_ff=512,
                            act="silu", norm="rmsnorm", pos="rope", max_pos=4096,
                            dropout=0.0, dtype=torch.bfloat16)
    model = bb.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    quant.quantize_backbone(model, "int8")
    frame, n_sink = 60, 61
    x = torch.randn(1, n_sink + 3 * frame, 256, generator=torch.Generator().manual_seed(1))
    x = x.to(dev, torch.bfloat16)
    outs = {}
    for stacked in (False, True):
        if stacked:
            bb.stack_layers(model)
        cache = bb.init_streaming_cache(cfg, 1, n_sink, 2, frame, device=dev)
        positions = torch.arange(x.shape[1], device=dev)
        before = (qmm.qmm_w8a16.launches, il.indexed_linear.launches)
        with torch.no_grad():
            bb.apply_streaming(model, x[:, :n_sink], positions[:n_sink], cache, 0, prefill=True)
            ys = [bb.apply_streaming(model, x[:, lo:lo + frame], positions[lo:lo + frame],
                                     cache, f % 2)[0]
                  for f, lo in enumerate(range(n_sink, x.shape[1], frame))]
        torch.cuda.synchronize()
        assert (qmm.qmm_w8a16.launches - before[0], il.indexed_linear.launches - before[1]) \
            == (7 * 3 * 4, 0)
        outs[stacked] = torch.cat(ys, 1)
    assert isinstance(model.layers, bb.StackedLayers)
    assert torch.equal(outs[True], outs[False])


# -- segment sum and row gather (graph baselines) --------------------------------
# f32.  The gather is a copy: equal to its twin bit for bit.  The sum is held
# to atol 1e-5 + rtol 1e-5: the twin's index_add_ adds with atomics in
# another order, and the ghost node's row sums the 132 ghost edges of each
# EAGLE-sized graph.  Two calls of the sum kernel must be bit-equal.


@pytest.fixture(scope="module")
def eagle_edges():
    """(4, 20480, 2) int32 edge ids of one collated MeshGraphNet batch at the
    EAGLE geometry (synthetic mesh 84x42: 3 528 nodes, 20 348 edges, padded
    to 3 529 and 20 480), RCM-relabeled as baselines_cli does."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset

    ds = SyntheticGraphDataset(n_trajectories=4, mode="train", window_length=2,
                               mesh_nodes=(84, 42))
    samples = [reorder_sample(ds[i], "rcm") for i in range(4)]
    n = max(s.mesh_pos.shape[1] for s in samples)
    e = max(s.edges.shape[0] for s in samples)
    return torch.from_numpy(collate_graphs(samples, n, e, 1)["edges"][:, 0])


@pytest.mark.parametrize("F", [1, 2, 32, 128])
@pytest.mark.parametrize("col", [0, 1])
def test_segment_kernels_match_twins_at_eagle_shapes(dev, eagle_edges, F, col):
    from fluid_llm_tpu_torch.ops import segment_ops as so

    B, E = eagle_edges.shape[:2]
    N = 3529
    g = torch.Generator().manual_seed(F + col)
    index = so.SegmentIndex(eagle_edges[..., col].to(dev), N)
    vals = torch.randn(B * E, F, generator=g).to(dev)
    nodes = torch.randn(B * N, F, generator=g).to(dev)
    before = (so.segment_sum.launches, so.segment_gather.launches)
    got_sum = so.segment_sum(vals, index)
    got_gather = so.segment_gather(nodes, index)
    torch.cuda.synchronize()
    assert (so.segment_sum.launches, so.segment_gather.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got_sum, so.segment_sum_ref(vals, index), atol=1e-5, rtol=1e-5)
    assert torch.equal(got_gather, so.gather_ref(nodes, index))
    assert torch.equal(so.segment_sum(vals, index), got_sum)  # deterministic


@pytest.mark.parametrize("F", [1, 128])
def test_segment_kernels_drop_out_of_range_ids(dev, F):
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(3)
    B, E, N = 3, 1000, 257
    ids = torch.sort(torch.randint(0, N, (B, E), generator=g), dim=1).values
    ids[:, -40:] = N
    ids[0, 3:9] = N + 11
    ids[2, 100] = -5
    index = so.SegmentIndex(ids.to(dev), N)
    vals = torch.randn(B * E, F, generator=g).to(dev)
    nodes = torch.randn(B * N, F, generator=g).to(dev)
    got = so.segment_gather(nodes, index)
    dropped = ((ids < 0) | (ids >= N)).reshape(-1).to(dev)
    assert torch.equal(got, so.gather_ref(nodes, index))
    assert bool((got[dropped] == 0).all())
    torch.testing.assert_close(so.segment_sum(vals, index), so.segment_sum_ref(vals, index),
                               atol=1e-5, rtol=1e-5)
    # nothing of batch element 0's ghosts lands in element 1's row 0
    kept = torch.where(dropped[:, None], 0.0, vals)
    want_row = kept.reshape(B, E, F)[1][ids[1].to(dev) == 0].sum(0)
    torch.testing.assert_close(so.segment_sum(vals, index)[N], want_row, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("F", [1, 2, 32, 128])
def test_segment_sum_is_the_csr_walk_bit_for_bit(dev, eagle_edges, F):
    """The sum kernel equals a CPU walk of the same CSR (each row's edges in
    ascending order, added one by one in f32 from 0) bit for bit, and so
    the CPU twin: on the EAGLE receivers with dropped ids (the ghost slot's
    neighbours beyond it, negative) and the ghost row, whose 132 edges are
    17 of the wide kernel's rounds and part of a narrow warp's chunk;
    again bit for bit when replayed from a CUDA graph."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    B, E = eagle_edges.shape[:2]
    N = 3529
    ids = eagle_edges[..., 1].clone()
    ids[0, 100:110] = N + 5
    ids[2, 7] = -1
    index_cpu, index = so.SegmentIndex(ids, N), so.SegmentIndex(ids.to(dev), N)
    row_ptr = index_cpu.csr()[1]
    assert int((row_ptr[1:] - row_ptr[:-1]).max()) > 16 * so.ROUND
    vals = torch.randn(B * E, F, generator=torch.Generator().manual_seed(F))
    want = so.csr_walk(vals, index_cpu)
    assert torch.equal(want, so.segment_sum_ref(vals, index_cpu))
    x = vals.to(dev)
    got = so.segment_sum(x, index)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for replayed in _graph_replays(lambda: so.segment_sum(x, index)):
        assert torch.equal(replayed.cpu(), want)


@pytest.mark.parametrize("F", [1, 2, 3, 128, 132])
@pytest.mark.parametrize("offset", [0, 1])
def test_segment_gather_every_plan_is_the_twin_bit_for_bit(dev, F, offset):
    """The gather under its plan and under every depth, a grid that walks
    several tiles a warp and one of single-warp blocks, at F 1, 2, 3, 128 and
    132, with ids out of range and node rows that start off 16 bytes
    (``offset`` floats into a buffer: 4-byte vectors then): equal to
    ``gather_ref`` bit for bit, also when replayed from a CUDA graph."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(F + offset)
    B, E, N = 3, 1000, 257
    ids = torch.randint(0, N, (B, E), generator=g)
    ids[:, -40:] = N
    ids[0, 3:9] = N + 11
    ids[2, 100] = -5
    index = so.SegmentIndex(ids.to(dev), N)
    buf = torch.randn(B * N * F + offset, generator=g).to(dev)
    nodes = buf[offset:].view(B * N, F)
    want = so.gather_ref(nodes, index)
    M = index.ids.shape[0]
    vec = so.gather_vec(F, nodes, want)
    assert (vec == 1) == (offset == 1 or F % 2 == 1)
    chosen = so.gather_plan(M, F, vec)
    plans = [chosen, (2, 1, 3), (chosen[0], chosen[1], max(1, chosen[2] // 4))]
    plans += [(d, 8, -(-so.gather_tiles(M, F // vec, d) // 8)) for d in so.GATHER_DEPTHS]
    for plan in plans:
        with mock.patch.object(so, "gather_plan", lambda *a, p=plan: p):
            got = so.segment_gather(nodes, index)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan
    for replayed in _graph_replays(lambda: so.segment_gather(nodes, index)):
        assert torch.equal(replayed, want)


def test_segment_functions_gradients_match_twins(dev, eagle_edges):
    """Autograd through SegmentSum / GatherNodes on the kernels against the
    same Functions on the twins (``kernels=False``)."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(5)
    B, E = eagle_edges.shape[:2]
    N, F = 3529, 32
    edges = eagle_edges.to(dev)
    vals = torch.randn(B, E, F, generator=g).to(dev)
    V = torch.randn(B, N, F, generator=g).to(dev)
    w = torch.randn(B, N, F, generator=g).to(dev)
    grads = {}
    for kernels in (True, False):
        tv, tV = vals.clone().requires_grad_(), V.clone().requires_grad_()
        s = so.segment_sum_nodes(tv, edges[..., 1], N, kernels)
        out = so.gather_nodes(tV + s, edges[..., 0], kernels)
        before = (so.segment_sum.launches, so.segment_gather.launches)
        (out.square().sum() + (s * w).sum()).backward()
        ran = (so.segment_sum.launches - before[0], so.segment_gather.launches - before[1])
        assert ran == ((1, 1) if kernels else (0, 0))
        grads[kernels] = (tv.grad, tV.grad)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_mgn_step_launches_and_agreement_on_card(dev):
    """A small MeshGraphNet (2 blocks) train-mode loss and gradient through
    the kernels against the twins, and the launch counts of one step: per
    rollout step 2 + 2P gathers and P sums forward; backward 2P sums (the
    blocks' gathers) and P gathers (their sums)."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset
    from fluid_llm_tpu_torch.models.baselines.mgn import MGN, mgn_loss
    from fluid_llm_tpu_torch.ops import segment_ops as so

    ds = SyntheticGraphDataset(n_trajectories=2, mode="valid", window_length=4)
    samples = [ds[i] for i in range(2)]
    b = collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                       max(s.edges.shape[0] for s in samples))
    inputs = [torch.from_numpy(b[k]).to(dev) for k in ("mesh_pos", "edges", "state", "node_type")]
    P, steps = 2, 3
    model = MGN(4, P, generator=torch.Generator().manual_seed(0)).to(dev)
    res = {}
    for kernels in (True, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        before = (so.segment_sum.launches, so.segment_gather.launches)
        _, oh, tgt, _ = model.apply(model.init_norm(dev), *inputs, train=True)
        loss = mgn_loss(oh, tgt, torch.from_numpy(b["mask"]).to(dev))
        loss.backward()
        ran = (so.segment_sum.launches - before[0], so.segment_gather.launches - before[1])
        want = (steps * (P + 2 * P), steps * (2 + 2 * P + P)) if kernels else (0, 0)
        assert ran == want
        res[kernels] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]))
    # the twins' atomics move the forward's last bits and with them ReLUs
    # within rounding of 0: the gradient bound is chip_smoke's GRAPH_GRAD_TOL
    assert abs(res[True][0] - res[False][0]) <= 1e-5 * abs(res[False][0])
    assert _rel(res[True][1], res[False][1]) <= 1e-3


# -- the segment kernels in bf16 and at GraphViT's cluster ids -----------------

def graphvit_launches(nb_gn: int):
    """(gathers, sums) of one GraphViT rollout step, forward and backward.
    Forward: positions (F 2) at both edge ends and by member; 2 gathers and
    1 sum in each of the nb_gn encoder blocks and the retrieve block; the
    node features (F 128) and the encoding (F 64) by member; the relative
    encoding (F 32) and the tokens (F w_size) summed into members.
    Backward: each gather of the blocks' and the members' node features is
    summed back, each sum of edge features and of the tokens gathered back;
    the position gathers and the encoding's sum take no gradient."""
    blocks = nb_gn + 1
    return (3 + 2 * blocks + 2, 1 + blocks + 1), (blocks + 1, 2 * blocks + 1)


@pytest.fixture(scope="module")
def graphvit_batch():
    """One collated GraphViT batch at the EAGLE geometry (synthetic mesh
    84x42, batch 4, clusters of 10), RCM-relabeled as ``baselines_cli``
    does in f32: the member ids unsorted."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset

    ds = SyntheticGraphDataset(n_trajectories=4, mode="train", window_length=2,
                               mesh_nodes=(84, 42), n_cluster=10)
    samples = [reorder_sample(ds[i], "rcm") for i in range(4)]
    return collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                          max(s.edges.shape[0] for s in samples),
                          max(s.cluster.shape[1] for s in samples), ghost_type_value=2)


@pytest.mark.parametrize("F", [2, 32, 64, 512])
def test_segment_kernels_at_graphvit_cluster_ids(dev, graphvit_batch, F):
    """The f32 sum equal to the walk of its CSR and the gather to its twin,
    bit for bit, by GraphViT's member ids (ghost slots dropped)."""
    from fluid_llm_tpu_torch.models.baselines.graphvit import member_index
    from fluid_llm_tpu_torch.ops import segment_ops as so

    b = graphvit_batch
    N = b["mesh_pos"].shape[2]
    index = member_index(torch.from_numpy(b["cluster"][:, 0]),
                         torch.from_numpy(b["cluster_mask"][:, 0]), N)
    ids = index.ids.view(4, -1)
    assert bool((ids[:, 1:] < ids[:, :-1]).any()) and bool((ids < 0).any())
    g = torch.Generator().manual_seed(F)
    vals = torch.randn(index.ids.shape[0], F, generator=g)
    nodes = torch.randn(index.n_rows, F, generator=g)
    index_dev = member_index(torch.from_numpy(b["cluster"][:, 0]).to(dev),
                             torch.from_numpy(b["cluster_mask"][:, 0]).to(dev), N)
    got = so.segment_sum(vals.to(dev), index_dev)
    gathered = so.segment_gather(nodes.to(dev), index_dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), so.csr_walk(vals, index))
    assert torch.equal(gathered.cpu(), so.gather_ref(nodes, index))


@pytest.mark.parametrize("F", [1, 32, 128, 512])
@pytest.mark.parametrize("offset", [0, 1])
def test_bf16_segment_kernels_are_their_twins_bit_for_bit(dev, F, offset):
    """bf16 values by unsorted ids with dropped ones (== N, beyond, < 0):
    the sum equal to ``csr_walk`` (f32 sums in the kernel's order, one
    rounding) bit for bit, within one rounding of ``segment_sum_ref`` (f32
    atomics on the card, then one rounding), and repeated bit for bit; the
    gather equal to ``gather_ref`` bit for bit, node rows off 16 bytes too
    (``offset`` elements into a buffer); the launches counted by the bf16
    wrappers alone."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(F + offset)
    B, E, N = 3, 4000, 700
    ids = torch.randint(0, N, (B, E), generator=g)
    ids[:, -40:] = N
    ids[0, 3:9] = N + 11
    ids[2, 100] = -5
    ids[1, 500:640] = 7  # a row of 140 edges: 18 rounds of the wide walk
    index = so.SegmentIndex(ids.to(dev), N)
    vals = torch.randn(B * E, F, generator=g).to(torch.bfloat16)
    buf = torch.randn(B * N * F + offset, generator=g).to(torch.bfloat16).to(dev)
    nodes = buf[offset:].view(B * N, F)
    before = {k: getattr(so, k).launches for k in
              ("segment_sum", "segment_gather", "segment_sum_bf16", "segment_gather_bf16")}
    got = so.segment_sum_bf16(vals.to(dev), index)
    gathered = so.segment_gather_bf16(nodes, index)
    torch.cuda.synchronize()
    after = {k: getattr(so, k).launches - v for k, v in before.items()}
    assert after == {"segment_sum": 0, "segment_gather": 0, "segment_sum_bf16": 1,
                     "segment_gather_bf16": 1}
    assert got.dtype == gathered.dtype == torch.bfloat16
    assert torch.equal(got, so.csr_walk(vals.to(dev), index))
    assert torch.equal(got.cpu(), so.csr_walk(vals, so.SegmentIndex(ids, N)))
    twin = so.segment_sum_ref(vals.to(dev), index).float()
    assert bool(((got.float() - twin).abs() <= 2 ** -7 * twin.abs()).all())
    assert torch.equal(so.segment_sum_bf16(vals.to(dev), index), got)
    assert torch.equal(gathered, so.gather_ref(nodes, index))
    with pytest.raises(ValueError):
        so.segment_sum(vals.to(dev), index)  # the f32 wrapper refuses bf16
    with pytest.raises(ValueError):
        so.segment_sum_nodes(vals.to(dev, torch.float16).view(B, E, F), index, N)


@pytest.mark.parametrize("F", [128, 512, 36, 1536])
@pytest.mark.parametrize("sort", [False, True])
def test_bf16_segment_sum_ring_is_the_csr_walk_bit_for_bit(dev, F, sort):
    """The bf16 sum by unsorted ids, and sorted (each row's edges
    consecutive, copied as runs), dropped ones too, with 30 rows of no
    edge and a row of 140, through ``sum_plan``'s ring and rings that hold
    fewer edge rows than it (a stage of 1 row, 2 stages, the long-row
    blocks' ring short of the 140 edges), several rows a warp (up to 32),
    more long rows than LONG_BLOCKS, and a slice of rows past RING_SLICE
    bytes (F 1536):
    equal to ``csr_walk`` bit for bit, again from a CUDA-graph replay;
    F 36 (not whole 16-byte vectors) takes the one-element walk.  A plan
    past shared memory or the kernel's bounds raises."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    g = torch.Generator().manual_seed(F)
    B, E, N = 3, 4000, 700
    ids = torch.randint(0, N, (B, E), generator=g)
    ids[ids // 10 == 2] = N  # rows 20-29 of each element: no edge
    ids[:, -40:] = N + 3
    ids[2, 100] = -5
    ids[1, 500:640] = 7  # 140 edges
    if sort:
        ids = torch.sort(ids, dim=1).values
    index = so.SegmentIndex(ids.to(dev), N)
    degree = (index.csr()[1][1:] - index.csr()[1][:-1]).cpu()
    assert int((degree == 0).sum()) >= 30 and int(degree.max()) >= 140
    vals = torch.randn(B * E, F, generator=g).to(torch.bfloat16)
    want = so.csr_walk(vals, so.SegmentIndex(ids, N))
    x = vals.to(dev)
    for plan in (so.sum_plan(F), (1, 2, 1, 1), (2, 2, 32, 3), (32, 1, 8, 16), (4, 1, 2, 2)):
        if so.ring_smem(F, plan) > so.SMEM_MAX:
            continue
        with mock.patch.object(so, "sum_plan", lambda *a, p=plan: p):
            got = so.segment_sum_bf16(x, index)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), plan
            for replayed in _graph_replays(lambda: so.segment_sum_bf16(x, index)):
                assert torch.equal(replayed.cpu(), want), plan
    if F % 8 == 0:
        for plan in ((3, 2, 1, 1), (4, 2, 33, 1), (4, 2, 1, so.RING_WARPS + 1), (32, 64, 4, 16)):
            with mock.patch.object(so, "sum_plan", lambda *a, p=plan: p):
                with pytest.raises(RuntimeError):
                    so.segment_sum_bf16(x, index)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_graphvit_step_launches_and_agreement_on_card(dev, dtype):
    """A GraphViT (w_size 512, 3 GNN blocks as published less one, 2
    attention blocks) train-mode loss and gradient through the kernels
    against the twins on a small mesh, as ``baselines_cli --dtype`` runs
    it, and the launches of one window of 2 steps (``graphvit_launches`` a
    step; under bf16 the position gathers and the encoding's sum stay
    f32)."""
    import argparse

    from fluid_llm_tpu_torch import baselines_cli as cli
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset
    from fluid_llm_tpu_torch.models.baselines.graphvit import GraphViT
    from fluid_llm_tpu_torch.ops import segment_ops as so

    args = argparse.Namespace(model="graphvit", dtype=dtype, noise_std=0.0, alpha=0.1)
    ds = SyntheticGraphDataset(n_trajectories=2, mode="valid", window_length=3, n_cluster=10)
    samples = [reorder_sample(ds[i], cli.order_mode(args)) for i in range(2)]
    b = collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                       max(s.edges.shape[0] for s in samples),
                       max(s.cluster.shape[1] for s in samples), ghost_type_value=2)
    batch = cli.to_device(b, dev)
    model = GraphViT(4, 512, n_attention=2, nb_gn=3, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    names = ("segment_gather", "segment_sum", "segment_gather_bf16", "segment_sum_bf16")
    res = {}
    for kernels in (True, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        before = {k: getattr(so, k).launches for k in names}
        _, oh, tgt, _ = cli.apply_model(args, model, {}, batch, train=True)
        loss = cli.graph_loss(args, oh, tgt, batch["mask"])
        loss.backward()
        ran = {k: getattr(so, k).launches - before[k] for k in names}
        fwd, bwd = graphvit_launches(3)
        if not kernels:
            want = dict.fromkeys(names, 0)
        elif dtype == "f32":
            want = dict(segment_gather=2 * (fwd[0] + bwd[0]), segment_sum=2 * (fwd[1] + bwd[1]),
                        segment_gather_bf16=0, segment_sum_bf16=0)
        else:  # f32: the 3 position gathers and the encoding's sum a step
            want = dict(segment_gather=2 * 3, segment_sum=2 * 1,
                        segment_gather_bf16=2 * (fwd[0] - 3 + bwd[0]),
                        segment_sum_bf16=2 * (fwd[1] - 1 + bwd[1]))
        assert ran == want
        res[kernels] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]))
    # f32: the twins' atomics move the last bits (chip_smoke's GRAPH_*_TOL);
    # bf16: those moves are rounded to bf16 (8 bits) where they land
    loss_tol, grad_tol = (1e-5, 1e-3) if dtype == "f32" else (1e-2, 5e-2)
    assert abs(res[True][0] - res[False][0]) <= loss_tol * abs(res[False][0])
    assert _rel(res[True][1], res[False][1]) <= grad_tol


# -- the indexed linear and short attention ------------------------------------

# (M, K, N) of the stacked streaming step: packed qkv, o, gate and up, down
INDEXED_SHAPES = [(60, 768, 2304), (60, 768, 768), (60, 768, 2048), (60, 2048, 768),
                  (61, 768, 2304), (61, 2048, 768)]


# (M, K, N, n_layers, li): the streaming step's shapes at the first and the
# last of 12 layers; one K step (K 128), several row tiles (M 64, 65, 661),
# M 1, and the huggyllama/llama-7b preset's MLP widths (d 4096, d_ff 11008)
# over a 2-layer stack: 64 K steps a block, and K-split clusters
INDEXED_CASES = [(M, K, N, 12, li) for M, K, N in INDEXED_SHAPES for li in (0, 11)] + [
    (1, 128, 256, 3, 2), (60, 128, 128, 2, 1), (61, 128, 384, 2, 0), (64, 768, 768, 12, 11),
    (65, 768, 2304, 12, 11), (661, 768, 768, 2, 1), (661, 2048, 768, 2, 1),
    (60, 4096, 11008, 2, 1), (61, 11008, 4096, 2, 1), (1, 4096, 11008, 2, 0),
]


@pytest.mark.parametrize("M,K,N,n_layers,li", INDEXED_CASES)
def test_indexed_linear_kernel_matches_twin(dev, M, K, N, n_layers, li):
    g = torch.Generator().manual_seed(M + K + N + li)
    w = (torch.randn(n_layers, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
    x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    index = torch.arange(n_layers, dtype=torch.int32, device=dev)[li]
    before = il.indexed_linear.launches
    out = il.indexed_linear(x, w, None, index)
    torch.cuda.synchronize()
    assert il.indexed_linear.launches == before + 1
    assert _rel(out, il.indexed_linear_ref(x, w, None, index)) <= REL_TOL
    assert _rel(out, x.float() @ w[li].float().T) <= REL_TOL


def test_indexed_linear_bias_leading_axes_and_raises(dev):
    """A bias added after the kernel, (bs, L, K) in; under autograd, on
    shapes ``supported`` refuses and on f32 it raises; an index out of range
    gives NaN, not a fault."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(3, 256, 128, generator=g) * 0.05).to(dev, torch.bfloat16)
    b = torch.randn(3, 256, generator=g).to(dev, torch.bfloat16)
    x = torch.randn(2, 5, 128, generator=g).to(dev, torch.bfloat16)
    index = torch.arange(4, dtype=torch.int32, device=dev)
    out = il.indexed_linear(x, w, b, index[2])
    assert out.shape == (2, 5, 256)
    assert _rel(out, il.indexed_linear_ref(x, w, b, index[2])) <= REL_TOL
    with pytest.raises(RuntimeError, match="forward only"):
        il.indexed_linear(x.clone().requires_grad_(), w, b, index[0])
    with pytest.raises(ValueError):
        il.indexed_linear(x[..., :64], w[..., :64].contiguous(), None, index[0])
    with pytest.raises(ValueError):
        il.indexed_linear(x.float(), w.float(), None, index[0])
    assert bool(torch.isnan(il.indexed_linear(x, w, None, index[3])).all())


@pytest.mark.parametrize("M,K,N", INDEXED_SHAPES)
def test_indexed_linear_strided_x_and_repeat(dev, M, K, N):
    """x a column slice of a wider tensor (read in place, any row stride a
    multiple of 8); two calls give equal bits (the K split's partial tiles
    are summed in rank order, no atomics)."""
    g = torch.Generator().manual_seed(K + N)
    w = (torch.randn(12, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
    wide = torch.randn(M, K + 136, generator=g).to(dev, torch.bfloat16)
    x = wide[:, 8:8 + K]
    index = torch.arange(12, dtype=torch.int32, device=dev)[5]
    out = il.indexed_linear(x, w, None, index)
    again = il.indexed_linear(x, w, None, index)
    torch.cuda.synchronize()
    assert _rel(out, il.indexed_linear_ref(x.contiguous(), w, None, index)) <= REL_TOL
    assert torch.equal(out, again)


@pytest.mark.parametrize("li", [12, -1])
def test_indexed_linear_out_of_range_is_nan_with_a_k_split(dev, li):
    """An index outside the stack writes NaN also where a cluster splits K
    (every rank leaves before the cluster's barriers)."""
    assert il.plan(60, 2048, 768)[1] > 1
    w = torch.zeros(12, 768, 2048, dtype=torch.bfloat16, device=dev)
    x = torch.ones(60, 2048, dtype=torch.bfloat16, device=dev)
    out = il.indexed_linear(x, w, None, torch.tensor(li, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())


@pytest.mark.parametrize("bs,L,H,hd,n_invalid", [
    (8, 601, 12, 64, 0), (1, 661, 12, 64, 181), (2, 1536, 2, 128, 37), (1, 5, 1, 64, 2),
    (2, 130, 4, 64, 40), (1, 1, 2, 64, 0), (2, 16, 2, 128, 16), (1, 63, 3, 64, 5),
    (1, 64, 2, 128, 0), (2, 65, 2, 64, 64), (1, 129, 4, 128, 3), (1, 661, 2, 128, 420),
    (1, 1536, 1, 64, 1536), (1, 601, 2, 128, 0),
])
def test_short_attention_kernel_matches_twin(dev, bs, L, H, hd, n_invalid):
    """L 1 to 1536, hd 64 and 128, q/k/v column slices of one fused
    projection; the first n_invalid keys invalid, so those query rows see
    only their forced diagonal (every row, where n_invalid == L).  Under
    both plans (64 and 128 query rows a block): one launch, finite, within
    REL_TOL of the twin on the valid and the invalid rows; a repeat equal
    bit for bit."""
    D = H * hd
    g = torch.Generator().manual_seed(L + hd)
    qkv = (torch.randn(bs, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    valid = (torch.arange(L)[None] >= n_invalid).expand(bs, L).int().contiguous().to(dev)
    rows = valid[0].bool()
    ref = sa.short_attention_ref(q, k, v, valid, H, hd)
    for q_rows in sa.QUERY_ROWS:
        with mock.patch.object(sa, "plan", lambda *a, p=q_rows: p):
            before = sa.short_attention_fwd.launches
            out = sa.short_attention_fwd(q, k, v, valid, H, hd)
            torch.cuda.synchronize()
            assert sa.short_attention_fwd.launches == before + 1
            assert bool(torch.isfinite(out).all())
            for part in (rows, ~rows):
                if part.any():
                    assert _rel(out[:, part], ref[:, part]) <= REL_TOL, q_rows
            assert torch.equal(sa.short_attention_fwd(q, k, v, valid, H, hd), out)


def test_short_attention_function_and_refusals(dev):
    """The gradient through ``ShortAttention`` (kernel forward, the twin
    recomputed) against autograd through the twin in f32; the wrapper
    refuses autograd, L past 1536 and head width 32."""
    g = torch.Generator().manual_seed(9)
    bs, L, H, hd = 2, 130, 4, 64
    base = [(torch.randn(bs, L, H * hd, generator=g) * 0.5).to(dev, torch.bfloat16)
            for _ in range(3)]
    valid = (torch.arange(L)[None] >= torch.tensor([[0], [40]])).int().contiguous().to(dev)
    w = torch.randn(bs, L, H * hd, generator=g).to(dev)
    ts = [t.clone().requires_grad_() for t in base]
    before = sa.short_attention_fwd.launches
    (sa.short_attention(*ts, valid, H, hd).float() * w).sum().backward()
    assert sa.short_attention_fwd.launches == before + 1
    refs = [t.float().requires_grad_() for t in base]
    (sa.short_attention_ref(*refs, valid, H, hd) * w).sum().backward()
    for t, r in zip(ts, refs):
        assert _rel(t.grad, r.grad) <= REL_TOL
    with pytest.raises(RuntimeError, match="forward only"):
        sa.short_attention_fwd(*ts, valid, H, hd)
    long = torch.zeros(1, 1537, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sa.short_attention_fwd(long, long, long, torch.ones(1, 1537, dtype=torch.int32,
                                                            device=dev), 1, 64)
    with pytest.raises(ValueError):
        sa.short_attention_fwd(*base, valid, 8, 32)


def test_stacked_streaming_and_short_rollouts_kernels_match_twins(dev):
    """A small bf16 flagship-shaped model (LLaMA 2 layers, d 128) stacked
    streams 6 steps: every linear through the indexed linear (5 a layer, a
    step and the prefill), no other matmul kernel, step 1 within REL_TOL of
    the twins and of the unrolled layout; the same weights built with
    ``attn_impl="short"`` roll out exactly (layer 0 of 2 through the short
    kernel) within REL_TOL of the twins."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.rollout.generate import generate
    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming

    cfg = Config(llm_backbone="fluid/llama-125m", llm_layers=2, half_precision=True,
                 autoreg_seq_len=5, resolution=64, absolute_time_ids=True,
                 pos_embedding_params={"pos_embedding_type": "rope_abs"},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=5, mode="valid",
                                  absolute_time=True)
    models = {}
    for name, kw in (("unrolled", {}), ("stacked", {}), ("short", {"attn_impl": "short"})):
        model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256, **kw)
        model.init_weights(torch.Generator().manual_seed(0))
        model.to(dev).prepare_inference_params(stack_layers=name != "unrolled")
        models[name] = model
    states, _, _, bc_mask, pos = next(make_batches(ds, 1, shuffle=False, device=dev))
    out = {}
    for kernels in (True, False):
        model = models["stacked"]
        model.kernels = kernels
        before = il.indexed_linear.launches
        out[kernels] = generate_streaming(model, states[:, :1], bc_mask, pos, 6)[1]
        torch.cuda.synchronize()
        assert il.indexed_linear.launches - before == (5 * 2 * 7 if kernels else 0)
    unrolled = generate_streaming(models["unrolled"], states[:, :1], bc_mask, pos, 6)[1]
    assert bool(torch.isfinite(out[True]).all())
    assert _rel(out[True][:, 0], out[False][:, 0]) <= REL_TOL
    assert _rel(out[True][:, 0], unrolled[:, 0]) <= REL_TOL
    short = {}
    for kernels in (True, False):
        model = models["short"]
        model.kernels = kernels
        before = (sa.short_attention_fwd.launches, xa.causal_attention.launches)
        short[kernels] = generate(model, states[:, :1], bc_mask, pos, 3)[1]
        torch.cuda.synchronize()
        ran = (sa.short_attention_fwd.launches - before[0],
               xa.causal_attention.launches - before[1])
        assert ran == ((3, 0) if kernels else (0, 0))
    assert _rel(short[True][:, 0], short[False][:, 0]) <= REL_TOL


POS_CASES = [  # (bs, tokens, d, table sizes, offset of the inputs in their buffers)
    (64, 11 * 60, 768, (15, 4, 11), 0),   # the training step: 42 240 rows, see-init frame
    (32, 11 * 60, 1024, (15, 4, 11), 0),  # the 350m rollout's window: 21 120 rows
    (4, 301, 772, (15, 4, 11), 0),        # d not a multiple of the slab (2 slabs of 97)
    (2, 2500, 768, (600, 300, 700), 0),   # tables too long for one 96-column accumulator
    (1, 5, 768, (15, 4, 11), 0),          # fewer rows than a block's rows in flight
    (3, 333, 768, (15, 4, 11), 1),        # inputs off 16 bytes: one float a load
    (2, 50, 6, (1, 1, 1), 0),             # one-row tables, d under a vector
]


def _pos_inputs(dev, bs, L, d, sizes, offset, seed):
    """h (bs, L, d) and the three tables in f32, ``offset`` floats into
    their buffers; ids (bs, L, 3) int64, unsorted and repeated, negative
    ones included."""
    g = torch.Generator().manual_seed(seed)

    def at_offset(*shape):
        n = 1
        for s in shape:
            n *= s
        return torch.randn(n + offset, generator=g).to(dev)[offset:].view(*shape)

    h = at_offset(bs, L, d)
    tables = [at_offset(n, d) for n in sizes]
    ids = torch.stack([torch.randint(-n, n, (bs, L), generator=g) for n in sizes], -1).to(dev)
    return h, tables, ids


@pytest.mark.parametrize("bs,L,d,sizes,offset", POS_CASES)
def test_pos_embed_kernels_match_twin(dev, bs, L, d, sizes, offset):
    """Forward: the twin bit for bit (the same f32 adds in the same order).
    Backward through autograd: dh the incoming gradient itself; each table's
    gradient the kernel's order of additions (``grad_walk`` under its plan)
    bit for bit, and within a few f32 roundings of the twin's
    ``index_put_`` sums (rtol 1e-5 of the largest element: sums of up to
    10 560 rows in another order)."""

    h, tables, ids = _pos_inputs(dev, bs, L, d, sizes, offset, seed=L + d)
    if offset:
        assert pe.vector(d, h, *tables) == 1
    gout = torch.randn(bs, L, d, generator=torch.Generator().manual_seed(7)).to(dev)
    leaves = [a.detach().clone().requires_grad_() for a in tables]
    hl = h.detach().requires_grad_()
    before = (pe.pos_embed_fwd.launches, pe.pos_embed_grad.launches)
    out = pe.pos_embed_add(hl, *leaves, ids)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (pe.pos_embed_fwd.launches - before[0], pe.pos_embed_grad.launches - before[1]) == (1, 1)
    twin_leaves = [a.detach().clone().requires_grad_() for a in tables]
    twin = pe.pos_embed_ref(h, *twin_leaves, ids)
    twin.backward(gout)
    assert torch.equal(out, twin)
    assert torch.equal(hl.grad, gout)
    ids2 = ids.reshape(-1, 3)
    _, rows = pe.grad_plan(ids2.shape[0], d, sum(sizes), pe.vector(d, gout, *tables),
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    walk = pe.grad_walk(gout.reshape(-1, d), pe.table_rows(ids2, *sizes), sum(sizes), rows)
    got = torch.cat([a.grad for a in leaves])
    assert torch.equal(got, walk)
    want = torch.cat([a.grad for a in twin_leaves])
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("bs,L,d,sizes,offset", [POS_CASES[0], POS_CASES[3], POS_CASES[5]])
def test_pos_embed_backward_repeats_bit_for_bit_also_in_a_graph(dev, bs, L, d, sizes, offset):
    """The two-launch backward (no atomics, fixed order) gives the same bits
    on a second call and from a CUDA graph; each call counts once."""

    _, _, ids = _pos_inputs(dev, bs, L, d, sizes, offset, seed=3)
    gout = _pos_inputs(dev, bs, L, d, sizes, offset, seed=4)[0].reshape(-1, d)
    ids2 = ids.reshape(-1, 3)
    before = pe.pos_embed_grad.launches
    first = pe.pos_embed_grad(gout, ids2, *sizes)
    again = pe.pos_embed_grad(gout, ids2, *sizes)
    torch.cuda.synchronize()
    assert pe.pos_embed_grad.launches - before == 2
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for replayed in _graph_replays(lambda: pe.pos_embed_grad(gout, ids2, *sizes)):
        for a, b in zip(first, replayed):
            assert torch.equal(a, b)


def test_pos_embed_routes_and_raises(dev):
    """``kernels=False`` and CPU tensors take the twin (no launch); bf16 on
    the card, mixed dtypes and ids of the wrong shape raise; int32 ids, and
    ids on the CPU, are cast or moved once and give the same result."""

    h, tables, ids = _pos_inputs(dev, 2, 60, 64, (15, 4, 11), 0, seed=9)
    before = (pe.pos_embed_fwd.launches, pe.pos_embed_grad.launches)
    twin = pe.pos_embed_add(h, *tables, ids, kernels=False)
    cpu = pe.pos_embed_add(h.cpu(), *(a.cpu() for a in tables), ids.cpu())
    assert (pe.pos_embed_fwd.launches, pe.pos_embed_grad.launches) == before
    assert torch.equal(cpu, twin.cpu())
    assert torch.equal(pe.pos_embed_add(h, *tables, ids.int()), twin)
    assert torch.equal(pe.pos_embed_add(h, *tables, ids.cpu()), twin)
    with pytest.raises(ValueError):
        pe.pos_embed_add(h.bfloat16(), *(a.bfloat16() for a in tables), ids)
    with pytest.raises(ValueError):
        pe.pos_embed_add(h, tables[0].double(), *tables[1:], ids)
    with pytest.raises(ValueError):
        pe.pos_embed_add(h, *tables, ids[:, :30])


def test_input_embeddings_launch_the_pos_kernels_with_kernels(dev):
    """A training forward and backward of ``InputEmbeddings`` on the card:
    one forward and one backward launch with ``kernels``, none without;
    the outputs equal and the tables' gradients within f32 rounding."""
    from fluid_llm_tpu_torch.config import EncoderConfig, PosEmbeddingConfig
    from fluid_llm_tpu_torch.models.embeddings import InputEmbeddings

    module = InputEmbeddings(3 * 16 * 16, 768, (15, 4, 11), EncoderConfig(),
                             PosEmbeddingConfig(in_emb_ln_eps=1e-5))
    module.reset_parameters(torch.Generator().manual_seed(1))
    module.to(dev)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(8, 11, 60, 3, 16, 16, generator=g).to(dev)
    pos = torch.stack([torch.arange(60) % 15, (torch.arange(60) // 15) % 4, torch.zeros(60, dtype=torch.long)], -1)
    pos = pos.expand(8, 11, 60, 3).clone()
    pos[..., 2] = torch.arange(11)[None, :, None]
    pos = pos.to(dev)
    grads, outs = {}, {}
    for kernels in (True, False):
        module.zero_grad(set_to_none=True)
        before = (pe.pos_embed_fwd.launches, pe.pos_embed_grad.launches)
        out = module(x, pos, kernels=kernels)
        out.square().mean().backward()
        torch.cuda.synchronize()
        ran = (pe.pos_embed_fwd.launches - before[0], pe.pos_embed_grad.launches - before[1])
        assert ran == ((1, 1) if kernels else (0, 0))
        outs[kernels] = out.detach()
        grads[kernels] = torch.cat([module.pos.x.grad, module.pos.y.grad, module.pos.t.grad])
    assert torch.equal(outs[True], outs[False])
    err = (grads[True] - grads[False]).abs().max().item()
    assert err <= 1e-5 * grads[False].abs().max().item()
