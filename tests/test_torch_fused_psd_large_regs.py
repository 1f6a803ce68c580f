"""The large-N kernel's register passes (csrc/fused_psd_large.cu:
large_regs_a, large_regs_b, psd_rows_sum), transcribed in numpy.

The CUDA kernel runs only on a card (chip_smoke.py); its index arithmetic
is pinned here: pass A's layout table and thread map (read out of the
source), the ring its cp.async copies fill and its u16 reads, the batched
register transform with its XOR-swizzled exchange, ``pass_bin`` -> bin
k1 + N1*k2 at every N from 32768 to 2^22, the inter-stage twiddle, pass
B's rows, its bins through shared memory, the two grid rules and the sum
of the partial rows (one row: the output itself; 2..8: the few-rows sum,
bit for bit psd_sum_kernel's float64 order; more: psd_sum). A bank model
holds the exchange's and the ring's claims. The transcription is held in
float32 against tests/golden.py (rtol 1e-5), and the plain version
against the JAX package's step (rtol 2e-5: two float32 budgets add).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.spectral import PsdStep as JaxPsdStep
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl

from golden import golden_accumulate
from test_torch_fused_psd_regs import (dif_regs, header_w16, pad, pass_bin,
                                       rev_bits, spans, wavefronts)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/fused_psd_large.cu"
#: The register passes' layouts, shared with the large chirp-Z kernel.
HEADER = SOURCE.with_name("fused_psd_large_regs.cuh")
SIZES = [1 << k for k in range(15, 23)]
#: Partial rows the few-rows sum takes (psd_sum.cuh's kSumLanes).
SUM_LANES = 8
GOLDEN_RTOL = 1e-5
CROSS_RTOL = 2e-5
#: Shared memory of an H100 SM (228 KB) and what each block reserves.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
#: Resident blocks of each pass on an H100 80GB HBM3 (132 SMs times the
#: blocks per SM cudaOccupancyMaxActiveBlocksPerMultiprocessor gives, as
#: chip_smoke.py prints them): pass A 3 at N1 = 1024, else 2; pass B 2.
H100_TWO_PER_SM = 264


def h100_resident(N):
    """(pass A, pass B) resident blocks on an H100 at N bins."""
    n1, _ = fl.large_split(N)
    return (132 * (3 if n1 == 1024 else 2), H100_TWO_PER_SM)


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def golden(raw, n_valid, window=None):
    N = raw.shape[1] // 2
    pwr, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid,
                               window=window)
    return np.fft.ifftshift(pwr)


def source_col_shape():
    """{N1: row} of col_shape's table in the source."""
    text = HEADER.read_text()
    body = text[text.index("constexpr int col_shape"):]
    body = body[:body.index("};")]
    rows = re.findall(r"\{([\d, ]+)\},\s*// (\d+)", body)
    return {int(n): tuple(int(v) for v in row.split(","))
            for row, n in rows}


def source_row_sum_stride():
    text = HEADER.read_text()
    body = text[text.index("constexpr int row_sum_stride"):]
    body = body[:body.index("};")]
    values = [int(v) for v in re.search(r"\{([\d, ]+)$", body)
              .group(1).split(",")]
    return dict(zip((256, 512, 1024, 2048), values))


# --- pass A's index arithmetic ---

def col_of(t, tid):
    return tid % t["V"] + t["V"] * ((tid >> 4) % (t["B"] // t["V"]))


def row_of(t, tid):
    T = 16 // t["V"]
    return (tid // t["V"]) % T + T * ((tid >> 4) // (t["B"] // t["V"]))


def col_index(t, c, e):
    p = pad(e) if t["pad"] else e
    return c * t["XS"] + (p ^ ((t["xmul"] * c) & 15))


def ring_offset(t, row, part):
    swap = (row >> 2) & 1 if t["C"] == 16 else 0
    return row * 2 * t["C"] + ((part ^ swap) << 4)


def last_element(n, t, k):
    """Element of slot k of thread t after the last pass at length n."""
    L, S = spans(n)[-1]
    RL = L // S
    TF = n // 16
    b = t + (k // RL) * TF
    bits = RL.bit_length() - 1
    rev = np.array([rev_bits(r, bits) for r in range(RL)])
    return (b // S) * L + b % S + rev[k % RL] * S


def pass_twiddles_c64(n):
    tw = fp.pass_twiddles(n)
    return (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)


def batch_transform(v, t, index, n, tw, w16, nbuf):
    """The register transform of length n on a batch of threads, as the
    kernel runs it: v (..., threads, 16) holds each thread's samples
    t + k*TF; index(e) (..., threads) gives a thread's exchange slot of
    element e. Returns the last pass's values (..., threads, 16), slot k
    holding element last_element(n, t, k)."""
    TF = n // 16
    buf = np.full(v.shape[:-2] + (nbuf,), np.nan, dtype=v.dtype)
    lead = np.indices(v.shape[:-1])[:-1] if v.ndim > 2 else ()

    def put(e, y):
        buf[(*lead, index(e))] = y

    def get(e):
        return buf[(*lead, index(e))]

    v = dif_regs(v, w16)
    for r in range(16):
        k1 = rev_bits(r, 4)
        put(t + k1 * TF, v[..., r] * tw[k1 * TF + t] if k1 else v[..., r])
    offset = n
    plan = fp.PASS_PLAN[n]
    out = np.empty_like(v)
    for j, (L, S) in enumerate(spans(n)[1:], start=1):
        RJ = L // S
        bits = RJ.bit_length() - 1
        last = j == len(plan) - 1
        for i in range(16 // RJ):
            b = t + i * TF
            n2 = b % S
            base = (b // S) * L + n2
            vv = dif_regs(np.stack([get(base + n1 * S) for n1 in range(RJ)],
                                   axis=-1), w16)
            for r in range(RJ):
                k1 = rev_bits(r, bits)
                if last:
                    out[..., i * RJ + r] = vv[..., r]
                else:
                    put(base + k1 * S, vv[..., r] * tw[offset + k1 * S + n2]
                        if k1 else vv[..., r])
        offset += L
    return out


def pass_a(raw_f, window, t, w16):
    """Pass A on one frame: every tile (vectorized), batch by batch, from
    the ring as the copies fill it, each batch's outputs staged through
    the exchange by (column, k1) and stored batch-major times the
    twiddle table in the same order. Returns the frame's scratch."""
    N1, N2, C, B = t["N1"], t["N2"], t["C"], t["B"]
    l2 = N2.bit_length() - 1
    tiles = N2 // C
    tw = pass_twiddles_c64(N1)
    table = fl.regs_inter_twiddle(N1 * N2)
    # The ring of every tile: 16-byte copy q -> row q // parts, its part.
    parts = 2 * C // 16
    ring = np.zeros((tiles, N1 * 2 * C), np.uint8)
    q = np.arange(N1 * parts)
    row, part = q // parts, q % parts
    for j in range(tiles):
        src = row * 2 * N2 + 2 * C * j + 16 * part
        dst = ring_offset(t, row, part)
        for b in range(16):
            ring[j, dst + b] = raw_f[src + b]
    tid = np.arange(t["threads_a"])
    c, th = col_of(t, tid), row_of(t, tid)
    k = np.arange(16)
    rows = th[:, None] + k[None, :] * t["TF1"]                # (threads, 16)
    scratch = np.full(N1 * N2, np.nan, np.complex64)
    win = None if window is None else np.asarray(window, np.float32)
    e = np.arange(B * N1)
    for s in range(t["subs"]):
        col = s * B + c
        byte = 2 * col[:, None]
        addr = ring_offset(t, rows, byte >> 4) + (byte & 15)
        re = ring[:, addr].astype(np.float32) - np.float32(127)
        im = ring[:, addr + 1].astype(np.float32) - np.float32(127)
        n2 = np.arange(tiles)[:, None, None] * C + col[None, :, None]
        if win is not None:
            w = win[(rows[None] << l2) + n2]
            re, im = re * w, im * w
        v = (re + 1j * im).astype(np.complex64)              # (tiles, thr, 16)
        cc = np.broadcast_to(c, v.shape[:-1])
        y = batch_transform(v, th, lambda e: col_index(t, cc, e), N1, tw,
                            w16, B * t["XS"])
        k1 = pass_bin(N1, last_element(N1, th[:, None], k[None, :]))
        xs = np.full((tiles, B * t["XS"]), np.nan, np.complex64)
        xs[:, col_index(t, c[:, None], k1)] = y
        run = (np.arange(tiles)[:, None] * (C // B) + s) * N1 * B + e
        scratch[run] = xs[:, col_index(t, e % B, e // B)] * table[run]
    return scratch


def ring_b(scratch_f, t):
    """Pass B's ring of every row tile, as its bulk copies fill it: run g
    of the tile (values k0 * B + g * N1 * B onward, B2 * B of them) at
    g * GS."""
    N1, N2, B, B2, GS = t["N1"], t["N2"], t["B"], t["B2"], t["GS"]
    tiles, runs, run = N1 // B2, N2 // B, B2 * B
    ring = np.full((tiles, runs * GS), np.nan, np.complex64)
    g, e = np.meshgrid(np.arange(runs), np.arange(run), indexing="ij")
    for j in range(tiles):
        ring[j, (g * GS + e).ravel()] = \
            scratch_f[(j * B2 * B + g * N1 * B + e).ravel()]
    return ring


def ring_index(t, r, n2):
    """Where pass B's thread of row r reads sample n2 of the ring."""
    return (n2 // t["B"]) * t["GS"] + r * t["B"] + n2 % t["B"]


def pass_b(scratch_f, acc, t, w16):
    """Pass B on one frame of a block group: every row tile (vectorized)
    from its ring, |X|^2 added into acc (tiles, threads, 16) in float32."""
    N1, N2, B2, TF = t["N1"], t["N2"], t["B2"], t["TF2"]
    tw = pass_twiddles_c64(N2)
    tid = np.arange(256)
    r, th = tid // TF, tid % TF
    e = th[:, None] + np.arange(16)[None, :] * TF
    v = ring_b(scratch_f, t)[:, ring_index(t, r[:, None], e)]
    rr = np.broadcast_to(r, v.shape[:-1])
    y = batch_transform(v, th, lambda e: rr * t["XS2"] + pad(e), N2, tw, w16,
                        B2 * t["XS2"])
    acc += (y.real * y.real + y.imag * y.imag).astype(np.float32)


def pass_b_bins(acc, t):
    """The row of a block group from its tiles' sums, through the bins in
    shared memory: (N,) float32."""
    N1, N2, B2, TF, XSR = t["N1"], t["N2"], t["B2"], t["TF2"], t["XSR"]
    tid = np.arange(256)
    r, th = tid // TF, tid % TF
    k2 = pass_bin(N2, last_element(N2, th[:, None], np.arange(16)[None, :]))
    by_bin = np.full((acc.shape[0], B2 * XSR), np.nan, np.float32)
    by_bin[:, r[:, None] * XSR + pad(k2)] = acc
    j = np.arange(B2 * N2)
    out = np.full(N1 * N2, np.nan, np.float32)
    k0 = np.arange(N1 // B2)[:, None] * B2
    out[k0 + (j % B2)[None] + N1 * (j // B2)[None]] = \
        by_bin[:, (j % B2) * XSR + pad(j // B2)]
    return out


def psd_sum_order(rows):
    """psd_sum_kernel in float64: lane l adds rows l, l + 8, ... from
    0.0; then the 8 lanes are added in order from 0.0."""
    lanes = []
    for lane in range(8):
        acc = np.zeros(rows.shape[1])
        for g in range(lane, rows.shape[0], 8):
            acc = acc + rows[g].astype(np.float64)
        lanes.append(acc)
    total = np.zeros(rows.shape[1])
    for lane in lanes:
        total = total + lane
    return total.astype(np.float32)


def few_rows_sum(rows):
    """psd_rows_sum: ((0.0 + row_0) + row_1) + ... in float64."""
    total = np.zeros(rows.shape[1])
    for row in rows:
        total = total + row.astype(np.float64)
    return total.astype(np.float32)


def regs_transcription(raw, n_valid, window=None,
                       resident=(H100_TWO_PER_SM, H100_TWO_PER_SM)):
    """numpy transcription of the register passes and the sum of their
    partial rows, on the grid regs_grid gives for ``resident`` blocks of
    each pass. Returns the (N,) float32 output and the partial rows."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = fl.regs_layout(N)
    w16 = header_w16().astype(np.complex64)
    group_a, group_b, G = fl.regs_grid(F, N, *resident)
    scratch = {}
    for j in range(-(-F // group_a)):     # pass A's blocks sum nothing
        for f in range(j * group_a, min((j + 1) * group_a, F, n_valid)):
            scratch[f] = pass_a(raw[f], window, t, w16)
    rows = []
    for g in range(G):
        acc = np.zeros((t["tiles_b"], 256, 16), np.float32)
        for f in range(g * group_b, min((g + 1) * group_b, F, n_valid)):
            pass_b(scratch[f], acc, t, w16)
        rows.append(pass_b_bins(acc, t))
    rows = np.asarray(rows)
    if G == 1:
        return rows[0], rows
    return (few_rows_sum(rows) if G <= SUM_LANES
            else psd_sum_order(rows)), rows


# --- the tables ---

def test_col_shape_is_the_sources():
    assert source_col_shape() == fl.COL_SHAPE
    assert source_row_sum_stride() == fl.ROW_SUM_STRIDE


@pytest.mark.parametrize("N", SIZES)
def test_layout_fits_two_blocks_an_sm(N):
    t = fl.regs_layout(N)
    N1, N2 = t["N1"], t["N2"]
    assert t["B"] * t["TF1"] == t["threads_a"] <= 256
    assert t["C"] % t["B"] == 0 and N2 % t["C"] == 0
    assert t["B2"] * t["TF2"] == 256 and N1 % t["B2"] == 0
    for smem in (t["smem_a"], t["smem_b"]):
        assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
    if N1 == 1024:   # pass A's 3 blocks an SM
        assert 3 * (t["smem_a"] + BLOCK_RESERVED) <= SM_SMEM
    # a tile row is whole 32-byte sectors up to N1 = 512
    assert 2 * t["C"] == (16 if N1 >= 1024 else 32)
    # the ring's copies split evenly over the threads, 16 bytes each
    assert (N1 * 2 * t["C"]) % (16 * t["threads_a"]) == 0
    assert (t["B2"] * N2 * 8) % (16 * 256) == 0
    # the bins of pass B's rows fit its exchange
    assert t["B2"] * t["XSR"] <= 2 * t["B2"] * t["XS2"]


@pytest.mark.parametrize("N1", sorted(fl.COL_SHAPE))
def test_thread_map_covers_each_batch_once(N1):
    N = N1 * (N1 if N1 > 128 else 256)
    t = fl.regs_layout(N)
    tid = np.arange(t["threads_a"])
    c, th = col_of(t, tid), row_of(t, tid)
    pairs = set(zip(c.tolist(), th.tolist()))
    assert pairs == {(cc, tt) for cc in range(t["B"])
                     for tt in range(t["TF1"])}
    # a half-warp is V adjacent columns of 16 / V adjacent threads
    for h in range(0, t["threads_a"], 16):
        assert len(set(c[h:h + 16].tolist())) == t["V"]
        assert len(set(th[h:h + 16].tolist())) == 16 // t["V"]


@pytest.mark.parametrize("N1", sorted(fl.COL_SHAPE))
def test_exchange_is_a_bijection_inside_each_column(N1):
    N = N1 * (N1 if N1 > 128 else 256)
    t = fl.regs_layout(N)
    c = np.repeat(np.arange(t["B"]), N1)
    e = np.tile(np.arange(N1), t["B"])
    slots = col_index(t, c, e)
    assert len(set(slots.tolist())) == t["B"] * N1
    assert np.all(slots // t["XS"] == c)


# --- banks ---

def pass_a_exchange(t):
    """Every warp instruction of pass A's exchange, as its 32 threads'
    float2 slots."""
    N1, TF = t["N1"], t["TF1"]
    for w0 in range(0, t["threads_a"], 32):
        tid = np.arange(w0, w0 + 32)
        c, th = col_of(t, tid), row_of(t, tid)
        for k1 in range(16):
            yield col_index(t, c, th + k1 * TF)
        for L, S in spans(N1)[1:]:
            RJ = L // S
            for i in range(16 // RJ):
                b = th + i * TF
                for n1 in range(RJ):
                    yield col_index(t, c, (b // S) * L + n1 * S + b % S)


def half_warp_wavefronts(slots):
    return max(wavefronts(np.concatenate([2 * h, 2 * h + 1]))
               for h in (slots[:16], slots[16:]))


@pytest.mark.parametrize("N1", sorted(fl.COL_SHAPE))
def test_pass_a_exchange_is_free_of_bank_conflicts(N1):
    """A half-warp's 64-bit accesses take one wavefront: the XOR and the
    column stride of col_shape keep every pass's reads and writes apart
    for the batch's thread map."""
    t = fl.regs_layout(N1 * (N1 if N1 > 128 else 256))
    for slots in pass_a_exchange(t):
        assert half_warp_wavefronts(slots) == 1


@pytest.mark.parametrize("N2", [256, 512, 1024, 2048])
def test_pass_b_exchange_is_free_of_bank_conflicts(N2):
    """Pass B's rows are K1's lanes: row r at r * (N2 + N2/16), pad_index
    inside it."""
    t = fl.regs_layout(N2 * (N2 // 2 if N2 > 256 else 128))
    assert t["N2"] == N2
    TF, XS2 = t["TF2"], t["XS2"]
    for w0 in range(0, 256, 32):
        tid = np.arange(w0, w0 + 32)
        r, th = tid // TF, tid % TF
        accesses = [r * XS2 + pad(th + k1 * TF) for k1 in range(16)]
        for L, S in spans(N2)[1:]:
            for i in range(16 // (L // S)):
                b = th + i * TF
                accesses += [r * XS2 + pad((b // S) * L + n1 * S + b % S)
                             for n1 in range(L // S)]
        for slots in accesses:
            assert half_warp_wavefronts(slots) == 1


@pytest.mark.parametrize("N2", [256, 512, 1024, 2048])
def test_pass_b_bins_through_shared_memory(N2):
    """The bins' writes (by pass_bin) and the coalesced reads take at most
    2 wavefronts a warp (once a block)."""
    t = fl.regs_layout(N2 * (N2 // 2 if N2 > 256 else 128))
    TF, B2, XSR = t["TF2"], t["B2"], t["XSR"]
    for w0 in range(0, 256, 32):
        tid = np.arange(w0, w0 + 32)
        r, th = tid // TF, tid % TF
        for k in range(16):
            k2 = pass_bin(N2, last_element(N2, th, k))
            assert wavefronts(r * XSR + pad(k2)) <= 2
    for j0 in range(0, B2 * N2, 32):
        j = np.arange(j0, j0 + 32)
        assert wavefronts((j % B2) * XSR + pad(j // B2)) <= 2


@pytest.mark.parametrize("N1,worst", [(128, 1), (256, 1), (512, 2),
                                      (1024, 2), (2048, 2)])
def test_ring_reads(N1, worst):
    """A thread reads the u16 of its column at rows t + k*TF1 of the ring:
    a warp's reads fall on distinct banks (or share words) at N1 <= 256;
    2-way from 512, where a half-warp is 16 rows of one column, the swapped
    halves keeping it there, as the source says."""
    t = fl.regs_layout(N1 * (N1 if N1 > 128 else 256))
    most = 0
    for w0 in range(0, t["threads_a"], 32):
        tid = np.arange(w0, w0 + 32)
        c, th = col_of(t, tid), row_of(t, tid)
        for s in range(t["subs"]):
            byte = 2 * (s * t["B"] + c)
            for k in range(16):
                row = th + k * t["TF1"]
                addr = ring_offset(t, row, byte >> 4) + (byte & 15)
                most = max(most, wavefronts(np.unique(addr // 4)))
    assert most == worst


@pytest.mark.parametrize("N1", sorted(fl.COL_SHAPE))
def test_ring_copies_fill_each_slot_once(N1):
    t = fl.regs_layout(N1 * (N1 if N1 > 128 else 256))
    parts = 2 * t["C"] // 16
    q = np.arange(N1 * parts)
    dst = ring_offset(t, q // parts, q % parts)
    assert np.all(dst % 16 == 0)
    assert sorted(dst.tolist()) == list(range(0, N1 * 2 * t["C"], 16))


@pytest.mark.parametrize("N1", sorted(fl.COL_SHAPE))
def test_staging_is_free_of_bank_conflicts(N1):
    """A batch's outputs go to the exchange by (column, k1) from the last
    pass's slots, and come back in scratch order: one wavefront a
    half-warp both ways."""
    t = fl.regs_layout(N1 * (N1 if N1 > 128 else 256))
    B = t["B"]
    for w0 in range(0, t["threads_a"], 32):
        tid = np.arange(w0, w0 + 32)
        c, th = col_of(t, tid), row_of(t, tid)
        for k in range(16):
            k1 = pass_bin(N1, last_element(N1, th, k))
            assert half_warp_wavefronts(col_index(t, c, k1)) == 1
    for j0 in range(0, B * N1, 32):
        e = np.arange(j0, j0 + 32)
        assert half_warp_wavefronts(col_index(t, e % B, e // B)) == 1


@pytest.mark.parametrize("N", SIZES)
def test_scratch_is_batch_major_and_pass_b_reads_rows(N):
    """scratch_index is a bijection; a batch's values are one run, so a
    warp's 32 stores are adjacent; pass B's ring rows hold rows k0 + r
    in order."""
    t = fl.regs_layout(N)
    N1, N2, B = t["N1"], t["N2"], t["B"]
    k1, n2 = np.meshgrid(np.arange(N1), np.arange(N2), indexing="ij")
    at = fl.scratch_index(N, k1, n2)
    assert np.array_equal(np.sort(at.ravel()), np.arange(N))
    # batch g: columns g*B .. g*B + B - 1 -> values [g*N1*B, (g+1)*N1*B),
    # value e of the batch (k1 = e / B, column e % B) at g*N1*B + e
    for g in (0, N2 // B - 1):
        e = np.arange(N1 * B)
        assert np.array_equal(at[e // B, g * B + e % B], g * N1 * B + e)
    values = (k1 * N2 + n2).astype(np.complex64)   # exact below 2^24
    scratch = np.empty(N, np.complex64)
    scratch[at] = values
    ring = ring_b(scratch, t)
    for j in (0, t["tiles_b"] - 1):
        for r in range(t["B2"]):
            row = ring[j, ring_index(t, r, np.arange(N2))]
            assert np.array_equal(row.real,
                                  (j * t["B2"] + r) * N2 + np.arange(N2))


@pytest.mark.parametrize("N", SIZES)
def test_pass_b_ring_is_free_of_bank_conflicts(N):
    """Pass B's bulk copies move whole runs, 16-byte aligned, to slots that
    do not overlap; its reads of a row take one wavefront a half-warp."""
    t = fl.regs_layout(N)
    B, B2, N2, GS, TF = t["B"], t["B2"], t["N2"], t["GS"], t["TF2"]
    run = B2 * B
    assert (8 * run) % 16 == 0 and (8 * GS) % 16 == 0 and GS >= run
    assert (8 * t["N1"] * B) % 16 == 0 and (8 * B2 * B) % 16 == 0
    for w0 in range(0, 256, 32):
        tid = np.arange(w0, w0 + 32)
        r, th = tid // TF, tid % TF
        for k in range(16):
            assert half_warp_wavefronts(ring_index(t, r, th + k * TF)) == 1


# --- the bins ---

@pytest.mark.parametrize("N", SIZES)
def test_pass_bin_lands_each_bin_once(N):
    """pass_bin of pass A's slots gives each column every k1 once; of
    pass B's, each row every k2 once; the row tiles' bins k0 + r + N1*k2
    cover the N bins once."""
    t = fl.regs_layout(N)
    N1, N2 = t["N1"], t["N2"]
    tid = np.arange(t["threads_a"])
    c, th = col_of(t, tid), row_of(t, tid)
    k1 = pass_bin(N1, last_element(N1, th[:, None], np.arange(16)[None]))
    for cc in range(t["B"]):
        assert sorted(k1[c == cc].ravel().tolist()) == list(range(N1))
    tid = np.arange(256)
    r, th = tid // t["TF2"], tid % t["TF2"]
    k2 = pass_bin(N2, last_element(N2, th[:, None], np.arange(16)[None]))
    for rr in range(t["B2"]):
        assert sorted(k2[r == rr].ravel().tolist()) == list(range(N2))
    k0 = np.arange(t["tiles_b"])[:, None, None] * t["B2"]
    bins = k0 + r[None, :, None] + N1 * k2[None]
    assert np.array_equal(np.sort(bins.ravel()), np.arange(N))


@pytest.mark.parametrize("N", [32768, 65536])
def test_batch_transform_in_float64_is_the_dft(N):
    """Pass A's batched transform with its swizzled exchange, in float64:
    each column's slots hold its DFT at pass_bin of their element."""
    t = fl.regs_layout(N)
    N1 = t["N1"]
    rng = np.random.default_rng(N)
    cols = rng.standard_normal((t["B"], N1)) + 1j * rng.standard_normal(
        (t["B"], N1))
    tid = np.arange(t["threads_a"])
    c, th = col_of(t, tid), row_of(t, tid)
    v = cols[c[:, None], th[:, None] + np.arange(16)[None] * t["TF1"]]
    tw = np.exp(-2j * np.pi * 0)  # placeholder for the exact table below
    exact = []
    for L, S in spans(N1)[:-1]:
        kk = np.arange(L // S)[:, None]
        nn = np.arange(S)[None, :]
        exact.append(np.exp(-2j * np.pi * (kk * nn % L) / L).ravel())
    tw = np.concatenate(exact)
    y = batch_transform(v, th, lambda e: col_index(t, c, e), N1, tw,
                        header_w16(), t["B"] * t["XS"])
    k1 = pass_bin(N1, last_element(N1, th[:, None], np.arange(16)[None]))
    X = np.fft.fft(cols, axis=1)
    np.testing.assert_allclose(y, X[c[:, None], k1], rtol=0,
                               atol=1e-12 * np.abs(X).max())


# --- the kernel in float32 ---

@pytest.mark.parametrize("N,F,n_valid,window,resident", [
    (32768, 4, 3, "hann", (264, 264)),          # 4 partial rows
    (32768, 16, 16, None, (264, 264)),          # 16 rows: psd_sum
    (65536, 4, 4, "blackman", (264, 264)),      # 4 rows
    (65536, 3, 3, None, (16, 16)),              # one row: the output
    (1 << 18, 2, 2, "hann", (264, 264)),        # two batches a tile
])
def test_transcription_matches_golden(N, F, n_valid, window, resident):
    raw = frames(F, N, 9 * N + F + n_valid)
    w = None if window is None else make_window(window, N)
    got, rows = regs_transcription(raw, n_valid, w, resident)
    assert len(rows) == fl.regs_grid(F, N, *resident)[2]
    np.testing.assert_allclose(got, golden(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)
    want = fl.fused_psd_large(torch.from_numpy(raw), n_valid, F,
                              None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got, want.numpy(), rtol=CROSS_RTOL)


@pytest.mark.parametrize("G", range(1, 9))
def test_few_rows_sum_is_psd_sums_order(G):
    """psd_rows_sum and psd_sum_kernel give the same bits for G <= 8; one
    row is itself (0.0 + r is r for r >= 0)."""
    rng = np.random.default_rng(G)
    rows = (rng.standard_exponential((G, 4096)) *
            10.0 ** rng.integers(-3, 9, (G, 4096))).astype(np.float32)
    rows[:, :16] = 0.0
    rows[0, 16:32] = np.float32(3e38)
    a, b = few_rows_sum(rows), psd_sum_order(rows)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    if G == 1:
        assert np.array_equal(a.view(np.uint32), rows[0].view(np.uint32))


def test_sum_sources_agree_on_the_row_limit():
    text = SOURCE.read_text()
    assert "groups_b <= kSumLanes" in text
    assert f"constexpr int kSumLanes = {SUM_LANES};" in (
        SOURCE.with_name("psd_sum.cuh").read_text())


# --- the grid rules ---

@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("F", [1, 3, 8, 16, 32, 250, 4096])
@pytest.mark.parametrize("resident", [132, 264, 528])
def test_large_group_is_the_least_that_fits(N, F, resident):
    t = fl.regs_layout(N)
    for tiles in (t["tiles_a"], t["tiles_b"]):
        g = fl.large_group(F, tiles, resident)
        assert 1 <= g <= F
        blocks = tiles * -(-F // g)
        if tiles <= resident:
            assert blocks <= resident
            assert g == 1 or tiles * -(-F // (g - 1)) > resident
        else:
            assert g == F   # one frame a block is already above a wave


@pytest.mark.parametrize("N,F,grid", [
    (1 << 20, 8, (3, 8, 1)),      # config 3's step: one row, no sum
    (1 << 20, 4, (2, 4, 1)),      # its last step (20 spectra: 8, 8, 4)
    (1 << 22, 8, (8, 8, 1)),
    (65536, 16, (1, 1, 16)),      # the windowed drive's timed step
    (65536, 12, (1, 1, 12)),      # the windowed drive's own step
    (32768, 32, (2, 1, 32)),
    (32768, 25, (2, 1, 25)),      # the session's step at 32768
    (1 << 17, 8, (1, 1, 8)),      # 8 rows: the few-rows sum
    (1 << 19, 8, (2, 4, 2)),
])
def test_regs_grid_at_the_drives_steps(N, F, grid):
    assert fl.regs_grid(F, N, *h100_resident(N)) == grid


def test_control_grid_is_unchanged():
    """The radix-2 control keeps its rule: 2 partial rows at 2^20, F = 8,
    8 at 65536 and 32768, 1 at 2^22."""
    assert fl.frames_per_block(8, 8, 1 << 20) == 4
    assert fl.frames_per_block(16, 16, 65536) == 2
    assert fl.frames_per_block(32, 32, 32768) == 4
    assert fl.frames_per_block(8, 8, 1 << 22) == 8


# --- the inter-stage twiddle ---

@pytest.mark.parametrize("N", [32768, 1 << 20, 1 << 22])
def test_inter_twiddle_is_the_rounded_float64_product(N):
    n1, n2 = fl.large_split(N)
    tab = fl.inter_tables(N)
    ang = -2.0 * np.pi / N * np.concatenate(
        [np.arange(n2, dtype=np.float64), n2 * np.arange(n1,
                                                          dtype=np.float64)])
    np.testing.assert_array_equal(tab, np.stack([np.cos(ang), np.sin(ang)],
                                                -1))
    got = fl.inter_twiddle(N)
    m = np.arange(0, n1, 7)[:, None] * np.arange(0, n2, 5)[None, :]
    c = tab[:, 0] + 1j * tab[:, 1]
    want = (c[m % n2] * c[n2 + m // n2]).astype(np.complex64)
    np.testing.assert_array_equal(got[::7, ::5], want)
    exact = np.exp(-2j * np.pi * m / N)
    np.testing.assert_allclose(got[::7, ::5].real, exact.real, rtol=0,
                               atol=6e-8)


# --- the plain version against the JAX package ---

@pytest.mark.parametrize("N,n_valid,window", [
    (32768, 7, "blackman"), (32768, 8, "hann"), (65536, 6, None),
    (65536, 8, "blackman")])
def test_plain_matches_jax_step(N, n_valid, window):
    raw = frames(8, N, 3 * N + n_valid)
    w = None if window is None else make_window(window, N)
    got = fl.fused_psd_large(torch.from_numpy(raw), n_valid, 8,
                             None if w is None else torch.from_numpy(w))
    step = JaxPsdStep(N, 8, window=w)
    assert step.path == "fft4"
    want = np.asarray(step(raw, n_valid), np.float64)
    np.testing.assert_allclose(got.numpy(), golden(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=CROSS_RTOL)


# --- the host path ---

def test_workspace_is_reused_per_key_and_bounded(monkeypatch):
    monkeypatch.setattr(fl, "_workspaces", type(fl._workspaces)())
    cpu = torch.device("cpu")
    a = fl._workspace(32768, 4, 1, cpu, 0)
    assert a[1] == 0 and fl._workspace(32768, 4, 1, cpu, 0) == a
    b = fl._workspace(32768, 4, 3, cpu, 0)
    assert b[1] == b[0] + 4 * 32768 * 8
    assert fl._workspace(32768, 4, 1, cpu, 7) != a   # another stream
    for F in (5, 6, 7, 8):
        fl._workspace(32768, F, 1, cpu, 0)
    assert len(fl._workspaces) == fl._WORKSPACES
    assert (32768, 4, 1, None, 0) not in fl._workspaces


def test_control_on_the_cpu():
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    raw = torch.from_numpy(frames(8, 32768, 21))
    w = torch.from_numpy(make_window("hann", 32768))
    fpp.COUNTS.reset()
    got = fpp.large_radix2_psd(raw, 6, 8, w)
    assert torch.equal(got, fl.fused_psd_large_reference(raw, 6, 8, w))
    assert fpp.COUNTS.plain["large_radix2"] == 1 and not fpp.COUNTS.kernel
    with pytest.raises(ValueError):
        fpp.large_radix2_psd(torch.zeros((8, 2 * 16384), dtype=torch.uint8),
                             8, 8)


@pytest.mark.cuda
def test_register_passes_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    for N, F in ((32768, 32), (1 << 20, 8)):
        raw = torch.from_numpy(frames(F, N, 17)).cuda()
        w = torch.from_numpy(make_window("hann", N)).cuda()
        for window in (None, w):
            got = fl.fused_psd_large(raw, F - 1, F, window)
            ctl = fpp.large_radix2_psd(raw, F - 1, F, window)
            want = fl.fused_psd_large_reference(raw, F - 1, F, window)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-5)
            np.testing.assert_allclose(got.cpu().numpy(), ctl.cpu().numpy(),
                                       rtol=1e-5)
