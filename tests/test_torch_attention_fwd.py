"""The fused-qkv attention forward's ``wgmma`` design (``csrc/attention.cu``):
which shapes take it and where the choice gives it (the grid fill), its
shared-memory plan, the refusals of a design that does not take a call,
and, emulated on the CPU, the arithmetic the kernel relies on: its rounding
points against the plain version, the fragment layouts of its two products
and its epilogue, and its persistent schedule (every tile once, stages
released by the warpgroups that read them).  On the card (``gpu``): the
kernel against the plain version at every shape it takes, its log-sum-exp,
the same bits twice, ``mma_ring`` by name beside it, and autograd through
it and the ``wgmma`` backward.

Tolerances: bf16 outputs within 2e-2 of max(1, the reference's largest
element), as the chip check holds every kernel (P is rounded to bf16 before
the product on both sides, from float32 values that differ in their last
bits); the log-sum-exp within 1e-4 of its largest element (float32 sums in
another order, ``ex2.approx``).
"""

import math

import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.ops import attention as _attn
from probabilisticdeepdiffusionmodels_torch.ops import (
    attention_design,
    qkv_attention,
    qkv_attention_grad,
    qkv_attention_plain,
)
from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import _SMEM_BYTES
from test_torch_ops import _ATTN_SHAPES, card  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

BF16_TOL = 2e-2
LSE_TOL = 1e-4
LOG2E = 1.4426950408889634


def _qkv(b, t, heads, ch, dtype=torch.bfloat16, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(b, t, 3 * heads * ch).astype(np.float32)).to(dtype)


def _lse(qkv, heads):
    """Each row's natural-log log-sum-exp of the scaled, rounded scores."""
    q, k, _ = _attn._split_heads(qkv, heads)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    return torch.logsumexp(torch.einsum("bthc,bshc->bhts", (q * scale).float(),
                                        (k * scale).float()), -1)


def _within(got, want, tol, floor=1.0):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(floor, float(want.float().abs().max())), err


# ------------------------------------------------------------------ choice

@pytest.mark.parametrize("b,t,heads,ch,design", [
    (128, 256, 4, 64, "wgmma"),      # the CIFAR-10 UNet's T = 256 and T = 64 sites
    (128, 64, 4, 64, "wgmma"),
    (128, 16, 4, 64, "mma_ring"),    # its T = 16 site: below wgmma's 64 rows
    (128, 256, 4, 96, "mma_ring"),   # unet_celebahq64's heads of 96 and 128
    (128, 64, 4, 128, "mma_ring"),
    (2, 1024, 4, 128, "mma_ring"),   # T > 256: a key row past one accumulator set
    (2, 1000, 4, 128, "mma_ring"),
    (40, 320, 4, 64, "mma_ring"),
    (40, 100, 4, 48, "wgmma"),       # ragged T, narrow heads
    (66, 200, 2, 32, "wgmma"),
    (33, 130, 4, 16, "wgmma"),
    (200, 100, 1, 48, "mma_ring"),   # heads x ch < 64, as the backward
    (40, 63, 4, 64, "mma_ring"),
    (16, 256, 4, 32, "mma_ring"),    # the 1-D UNet's sites (64 items): the grid fill
    (16, 128, 4, 32, "mma_ring"),
    (8, 64, 4, 32, "mma_ring"),      # the 3-D UNet's T = 64 site (32 items)
    (4, 256, 4, 64, "mma_ring"),     # the grid's batch of 4, the IDDPM views' of 1
    (1, 64, 4, 64, "mma_ring"),
    (16, 256, 4, 64, "mma_ring"),    # 64 items, under half an H100's 132 SMs
    (17, 256, 4, 64, "wgmma"),       # 68 items
])
def test_forward_design_names(b, t, heads, ch, design):
    """``wgmma`` for bf16 heads of 16..64 with 64 <= T <= 256 and heads x
    ch >= 64 where the (head, sample) items are at least half the SMs (a
    CPU tensor counts an H100's 132), ``mma_ring`` for every other bf16 shape,
    ``scalar_f32`` for float32; the C entry point's numbers."""
    qkv = torch.empty(b, t, 3 * heads * ch, dtype=torch.bfloat16)
    assert attention_design(qkv, heads) == design
    assert attention_design(qkv.float(), heads) == "scalar_f32"
    assert _attn.DESIGNS == {"mma_ring": 0, "scalar_f32": 0, "wgmma": 1}


@pytest.mark.parametrize("b,t,heads,ch", [(16, 256, 4, 32), (16, 128, 4, 32), (8, 64, 4, 32),
                                          (2, 100, 4, 48), (3, 200, 2, 32), (5, 130, 4, 16)])
def test_forward_grid_fill_leaves_wgmma_by_name(b, t, heads, ch):
    """Where the items are fewer than half the SMs the choice is ``mma_ring``,
    but ``wgmma`` still takes the shape, so it runs there by name (the chip
    check times both sides of the rule at the 1-D and 3-D UNets' sites)."""
    qkv = torch.empty(b, t, 3 * heads * ch, dtype=torch.bfloat16)
    assert attention_design(qkv, heads) == "mma_ring"
    assert _attn._forward_design(qkv, heads, "wgmma") == "wgmma"


@pytest.mark.parametrize("sms,b,design", [(132, 17, "wgmma"), (132, 16, "mma_ring"),
                                          (114, 15, "wgmma"), (114, 14, "mma_ring"),
                                          (78, 10, "wgmma"), (78, 9, "mma_ring")])
def test_forward_grid_fill_follows_the_card(sms, b, design, monkeypatch):
    """The fill rule reads the card's SM count (132 on an H100 SXM, 114 on
    a PCIe card): ``wgmma`` from half as many items as SMs."""
    monkeypatch.setattr(_attn, "_sm_count", lambda device: sms)
    qkv = torch.empty(b, 256, 768, dtype=torch.bfloat16)
    assert attention_design(qkv, 4) == design


def test_forward_design_at_the_cifar_sites():
    """Every ``_ATTN_SHAPES`` entry in 4 heads: ``wgmma`` at T = 256 and 64
    with heads of 64 only."""
    got = [attention_design(torch.empty(s, dtype=torch.bfloat16), 4) for s in _ATTN_SHAPES]
    assert got == ["wgmma", "wgmma"] + ["mma_ring"] * (len(_ATTN_SHAPES) - 2)


@pytest.mark.parametrize("t", [64, 100, 128, 129, 192, 200, 256])
def test_forward_smem_plan_fits(t):
    """At every T the design takes, its stages fit a block's shared memory
    (at least two; four at one key tile, an even count there); the plan's
    bytes: the stages of Q, K and V (64-token tiles of 128-byte rows), four
    mbarriers a stage of the most, the 1,024-byte alignment slack."""
    stages = _attn._fwd_wgmma_stages(t)
    nt = -(-t // 64)
    assert stages >= 2 and (nt > 1 or stages % 2 == 0)
    assert _attn._fwd_wgmma_smem(t, stages) <= _SMEM_BYTES
    assert _attn._fwd_wgmma_smem(t, stages) == 1024 + stages * 3 * nt * 64 * 128 + 4 * 4 * 8
    if stages < 4:
        assert _attn._fwd_wgmma_smem(t, stages + 1) > _SMEM_BYTES
    assert {64: 4, 128: 4, 192: 3, 256: 2}.get(t, stages) == stages


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("shape,heads,dtype,design", [
    ((2, 64, 768), 4, torch.bfloat16, "nope"),
    ((2, 64, 768), 4, torch.bfloat16, "scalar_f32"),
    ((2, 64, 768), 4, torch.float32, "mma_ring"),
    ((2, 64, 768), 4, torch.float32, "wgmma"),
    ((2, 257, 768), 4, torch.bfloat16, "wgmma"),     # one key past four tiles
    ((2, 16, 768), 4, torch.bfloat16, "wgmma"),      # T < 64
    ((2, 320, 768), 4, torch.bfloat16, "wgmma"),     # T > 256
    ((2, 64, 1152), 4, torch.bfloat16, "wgmma"),     # heads of 96
    ((2, 100, 144), 1, torch.bfloat16, "wgmma"),     # heads x ch < 64
    ((2, 64, 1536), 4, torch.bfloat16, "wgmma"),     # heads of 128
    ((2, 64, 768), 4, torch.bfloat16, "two_pass"),   # the backward's name
])
def test_unfit_design_raises(shape, heads, dtype, design):
    """A design name that is unknown, or whose kernel does not take the
    dtype or shape, raises before any launch (the check runs on the CPU
    tensor; a CUDA call runs it after its own checks)."""
    qkv = torch.empty(shape, dtype=dtype)
    with pytest.raises(ValueError, match="design"):
        _attn._forward_design(qkv, heads, design)


@pytest.mark.parametrize("design", [None, "mma_ring", "wgmma"])
def test_a_cpu_tensor_takes_the_plain_version(design):
    qkv = _qkv(2, 64, 4, 16, seed=1)
    assert torch.equal(qkv_attention(qkv, 4, design=design), qkv_attention_plain(qkv, 4))


# ------------------------------------------------------------ arithmetic

def _kernel_math(qkv, heads):
    """The wgmma forward's arithmetic in torch: q and k scaled and rounded
    to bf16, S = qs ks^T in float32, each row's maximum m over the whole key
    row, p = 2^(S log2 e - m log2 e) and l = sum p in float32, O = (bf16(p)
    V) / l rounded to bf16, L = m + ln l."""
    b, t, c3 = qkv.shape
    q, k, v = _attn._split_heads(qkv, heads)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    s = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * LOG2E - m * LOG2E)
    l = p.sum(-1)
    o = torch.einsum("bhts,bshc->bthc", p.to(torch.bfloat16).float(), v.float())
    o = (o / l.transpose(1, 2)[..., None]).to(torch.bfloat16)
    return o.reshape(b, t, c3 // 3), m[..., 0] + torch.log(l)


@pytest.mark.parametrize("b,t,heads,ch", [(2, 64, 4, 64), (1, 256, 4, 64), (2, 100, 4, 48),
                                          (3, 200, 2, 32), (2, 130, 4, 16)])
def test_kernel_rounding_points_hold_the_plain_version(b, t, heads, ch):
    """Dividing O by l after the product of the unnormalised bf16 P (the
    kernel's order) stays within the chip check's tolerance of the plain
    version, which rounds the normalised softmax; L = m + ln l is the
    log-sum-exp the backward reads."""
    qkv = _qkv(b, t, heads, ch, seed=t + ch)
    out, lse = _kernel_math(qkv, heads)
    _within(out, qkv_attention_plain(qkv, heads), BF16_TOL)
    _within(lse, _lse(qkv, heads), LSE_TOL)


def _sw128(r, c):
    """Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
    (``hopper.cuh::sw128``, the layout TMA lands a 64-channel box in)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _landed(tile):
    """A 64 x 64 tile of element values, laid out as TMA lands it: element
    (r, col) at byte _sw128(r, col // 8) + 2 (col % 8); returns the bytes'
    element values, one entry a bf16 slot."""
    mem = np.full(64 * 64, -1, dtype=np.int64)
    for r in range(64):
        for col in range(64):
            mem[(_sw128(r, col // 8) + 2 * (col % 8)) // 2] = tile[r, col]
    return mem


def test_q_fragments_from_the_swizzled_tile():
    """``ldmatrix.x4`` at sw128(16 w + (lane & 15), 2 kk + (lane >> 4)) gives
    each lane the A fragment of rows 16 w.. and channels 16 kk.. of q: a0 =
    A[g][2t, 2t+1], a1 = A[g+8][..], a2 = A[g][2t+8, ..], a3 = A[g+8][2t+8, ..]."""
    tile = np.arange(64 * 64).reshape(64, 64)
    mem = _landed(tile)
    for w in range(4):
        for kk in range(4):
            addr = [_sw128(16 * w + (lane & 15), 2 * kk + (lane >> 4)) for lane in range(32)]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):
                    # register i: matrix i, whose row lane // 4 lane 8 i + lane // 4 addressed
                    row_addr = addr[8 * i + lane // 4]
                    got = [mem[(row_addr + 4 * (lane % 4)) // 2 + j] for j in range(2)]
                    r = 16 * w + g + 8 * (i & 1)
                    col = 16 * kk + 2 * t + 8 * (i >> 1)
                    assert got == [tile[r, col], tile[r, col + 1]], (w, kk, lane, i)


@pytest.mark.parametrize("kt", [1, 2, 3, 4])
def test_p_fragments_from_the_score_accumulators(kt):
    """The m64nN accumulator of S (d[4 n8 + e]: row g + 8 (e >> 1), key
    8 n8 + 2 t + (e & 1)) packed as pa[kk][e] = (d[i], d[i + 1]) with
    i = 4 (2 kk + (e >> 1)) + 2 (e & 1) is the A fragment of k-step kk of
    P V: every key of the row once, in the A layout."""
    n = 64 * kt
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        acc = {4 * n8 + e: (g + 8 * (e >> 1), 8 * n8 + 2 * t + (e & 1))
               for n8 in range(n // 8) for e in range(4)}
        seen = set()
        for kk in range(n // 16):
            for e in range(4):
                i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1)
                want_row, want_key = g + 8 * (e & 1), 16 * kk + 2 * t + 8 * (e >> 1)
                assert acc[i] == (want_row, want_key) and acc[i + 1] == (want_row, want_key + 1)
                seen |= {i, i + 1}
        assert seen == set(acc)


@pytest.mark.parametrize("ch", [16, 32, 48, 64])
def test_output_staging_round_trip(ch):
    """O staged over the tile's Q rows (thread pair (row 16 w + g + 8 half,
    channels 8 n8 + 2 t) at sw128(row, n8) + 4 t) and read back 16 bytes a
    step (row idx // (ch / 8), chunk idx % (ch / 8)) puts each of the 64 x ch
    outputs in its place once."""
    mem = {}
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for half in range(2):
                row = 16 * w + g + 8 * half
                for n8 in range(ch // 8):
                    for j in range(2):
                        byte = _sw128(row, n8) + 4 * t + 2 * j
                        assert byte not in mem
                        mem[byte] = (row, 8 * n8 + 2 * t + j)
    got = {}
    for idx in range(64 * (ch // 8)):
        row, c8 = idx // (ch // 8), idx % (ch // 8)
        for j in range(8):
            got[(row, 8 * c8 + j)] = mem[_sw128(row, c8) + 2 * j]
    assert got == {(r, c): (r, c) for r in range(64) for c in range(ch)}


def _schedule(items, grid, kt):
    """The kernel's persistent schedule, as its loops walk it: per block,
    the items blockIdx.x, + gridDim.x, ... (local k, in stage k % stages),
    and each consumer warpgroup's tiles gt = c, c + 2, ... of the block's
    k * kt + t; returns, per block, its item count and {c: [(k, t), ...]}."""
    blocks = []
    for blk in range(grid):
        mine = (items - blk + grid - 1) // grid
        blocks.append((mine, {c: [divmod(gt, kt) for gt in range(c, mine * kt, 2)]
                              for c in (0, 1)}))
    return blocks


@pytest.mark.parametrize("items,grid,t", [(512, 132, 256), (512, 132, 64), (512, 132, 192),
                                          (512, 132, 128), (4, 4, 256), (7, 3, 64),
                                          (10, 4, 192), (5, 2, 130), (1, 1, 100)])
def test_persistent_schedule(items, grid, t):
    """Every (item, query tile) is computed once; each item is released by
    as many warpgroups as its stage's empty barrier counts (two at two key
    tiles or more, one at one), each after its last tile of the item; a
    warpgroup waits on every phase of each stage it reads, from the first
    (a parity wait a phase ahead would pass on the phase before)."""
    kt = -(-t // 64)
    stages = _attn._fwd_wgmma_stages(t)
    done = []
    for blk, (mine, tiles) in enumerate(_schedule(items, grid, kt)):
        releases = {}
        for c in (0, 1):
            used = {}
            for k, tt in tiles[c]:
                done.append((blk + k * grid, tt))
                if tt + 2 >= kt:
                    releases[k] = releases.get(k, 0) + 1
                used.setdefault(k % stages, set()).add(k // stages)
            for s, uses in used.items():
                assert uses == set(range(len(range(s, mine, stages)))), (c, s, uses)
        assert releases == {k: 2 if kt > 1 else 1 for k in range(mine)}
    assert sorted(done) == [(i, tt) for i in range(items) for tt in range(kt)]


# ------------------------------------------------------------- on the card

# the shapes the wgmma design takes: the CIFAR-10 UNet's two at batch 128,
# ragged T and narrow heads (three key tiles, an odd tile count a block, the
# last key tile part-filled), one sample
_WGMMA_SITES = [(128, 256, 4, 64), (128, 64, 4, 64), (2, 100, 4, 48), (3, 200, 2, 32),
                (2, 192, 1, 64), (5, 130, 4, 16), (1, 256, 4, 64), (3, 128, 4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["wgmma", "mma_ring"])
def test_card_forward_design_matches_plain(design, card):  # noqa: F811
    """At every shape ``wgmma`` takes, each design by name: the output
    within 2e-2 of the plain version, each row's log-sum-exp within 1e-4
    of the plain one's largest element, the same bits twice, one count a
    call; the choice ``wgmma`` where the items are half the SMs or more."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, heads, ch in _WGMMA_SITES:
        qkv = torch.randn(b, t, 3 * heads * ch, device="cuda", generator=gen).to(torch.bfloat16)
        assert _attn._fwd_wgmma_takes(t, heads, ch)
        assert attention_design(qkv, heads) == ("wgmma" if 2 * b * heads >= sms else "mma_ring")
        before = qkv_attention.launches
        runs = [_attn.attention_forward(qkv, heads, design) for _ in range(2)]
        torch.cuda.synchronize()
        assert qkv_attention.launches - before == 2
        assert all(torch.equal(x, y) for x, y in zip(runs[0], runs[1])), (b, t, heads, ch)
        _within(runs[0][0], qkv_attention_plain(qkv, heads), BF16_TOL)
        _within(runs[0][1], _lse(qkv, heads), LSE_TOL)
        assert torch.equal(qkv_attention(qkv, heads, design=design), runs[0][0])


@pytest.mark.gpu
def test_card_forward_refuses_an_unfit_design(card):  # noqa: F811
    qkv = torch.randn(4, 16, 768, device="cuda").to(torch.bfloat16)
    before = qkv_attention.launches
    with pytest.raises(ValueError, match="design 'wgmma'"):
        qkv_attention(qkv, 4, design="wgmma")
    assert qkv_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(16, 256), (16, 64)])
def test_card_autograd_through_the_wgmma_forward(b, t, card):  # noqa: F811
    """Autograd through the ``wgmma`` forward (by name: 64 items choose
    ``mma_ring``) and the ``wgmma`` backward (one launch each) against autograd through the plain version: dqkv within
    1e-2 of its largest element, the chip check's backward tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(t)
    qkv = torch.randn(b, t, 768, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(b, t, 256, device="cuda", generator=gen).to(torch.bfloat16)
    leaf = qkv.clone().requires_grad_(True)
    before = (qkv_attention.launches, qkv_attention_grad.launches)
    out = qkv_attention(leaf, 4, design="wgmma")
    out.backward(g)
    torch.cuda.synchronize()
    assert (qkv_attention.launches - before[0], qkv_attention_grad.launches - before[1]) == (1, 1)
    ref_leaf = qkv.clone().requires_grad_(True)
    qkv_attention_plain(ref_leaf, 4).backward(g)
    _within(out.detach(), qkv_attention_plain(qkv, 4), BF16_TOL)
    _within(leaf.grad, ref_leaf.grad, 1e-2, floor=0.0)
