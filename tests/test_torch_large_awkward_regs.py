"""The redesigned large awkward-N kernels, transcribed in numpy from their
index arithmetic: BL's register passes (csrc/fused_psd_chirp_large.cu:
chirp_regs_a, chirp_regs_b, chirp_regs_c on the large kernel's
csrc/fused_psd_large_regs.cuh) and ML's division-free passes
(csrc/fused_psd_mixed_large.cu: ml_cols_kernel, ml_rows_kernel on the pass
table of csrc/fused_psd_mixed_ring.cuh).

The CUDA kernels run only on a card (chip_smoke.py phase 15); here:
- BL at every M from 2^15 to 2^22: the rows pass A's ring holds and copies
  (only those with a sample below N, in pieces of the frames' copy
  width), the chirp table in the threads' order and its inverse, the B / M
  table in the row transform's element order, pass B's stage and stores
  (the batch-major scratch order and its inverse), pass C's copies into
  the exchange and the bins it keeps (each m < N once, at most half of a
  column's); shared bytes within two blocks an SM; bank models of pass B's
  stage and pass A's narrow copies;
- BL's three passes thread by thread in float32 against tests/golden.py;
- ML over all 1192 eligible N: the split (N2 even), the layouts, the
  division constants exact for every butterfly of every pass of both
  plans, the plan ints as read_ml_plan checks them, the tile-major scratch
  order and its inverse, pass B's copies (each value of the tile's rows
  once), the copy width; a bank model of pass A's exchange;
- ML's two passes thread by thread in float64 against numpy.fft and in
  float32 against tests/golden.py;
- the route (every N of each band on the new form) and ML's row shapes;
  the source edits of probes/large_awkward_builds.py apply to the shipped
  sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_large as bl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large as ml
from rtl_power_fftw_tpu_torch.probes import large_awkward_builds

from golden import golden_accumulate
from test_torch_awkward_regs import (forward_passes, last_pass_turn,
                                     transposed_passes)
from test_torch_fused_psd_large_regs import (SUM_LANES, batch_transform,
                                             col_index, few_rows_sum,
                                             last_element, pass_twiddles_c64,
                                             psd_sum_order, ring_b,
                                             ring_index, ring_offset,
                                             wavefronts)
from test_torch_fused_psd_mixed import dequantize, dft_natural
from test_torch_fused_psd_regs import dif_regs, header_w16, pad, pass_bin, \
    rev_bits

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
LOG2M = range(15, 23)
GOLDEN_RTOL = 1e-5
#: Shared bytes two blocks of 256 threads may each have on an H100 SM
#: (228 KB, 1 KB a block reserved).
TWO_A_SM = (233472 - 2 * 1024) // 2
#: Resident blocks of each BL pass and of ML's passes the grids are
#: computed for here: two a SM of an H100's 132.
RESIDENT = 264
ML_SIZES = ml.eligible_sizes()


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def golden(raw, n_valid, window=None):
    N = raw.shape[1] // 2
    pwr, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid,
                               window=window)
    return np.fft.ifftshift(pwr)


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def budget(raw, n_valid, window, plain, gold):
    """GOLDEN_RTOL, or twice the plain version's own distance from the
    golden where that is larger (a single windowed periodogram's deepest
    bins, where every float32 FFT is further than 1e-5 away)."""
    w = None if window is None else torch.from_numpy(window)
    want = plain(torch.from_numpy(raw), n_valid, raw.shape[0], w).numpy()
    return max(GOLDEN_RTOL, 2 * max_rel(want, gold))


def sum_rows(rows):
    """The partial rows as the launch adds them: one is the output; 2..8
    psd_rows_sum; more psd_sum.cuh."""
    rows = np.asarray(rows)
    if len(rows) == 1:
        return rows[0]
    return (few_rows_sum(rows) if len(rows) <= SUM_LANES
            else psd_sum_order(rows))


def bl_sizes(log2m):
    """The smallest and the largest even N whose chirp size is 2^log2m,
    within BL's band."""
    M = 1 << log2m
    lo = max(bl.MIN_N, M // 4 + 2)
    hi = min(bl.MAX_N, M // 2)
    assert fb.chirp_size(lo) == M == fb.chirp_size(hi)
    return lo, hi


# --- BL: layouts and tables ---


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_layout_of_every_m(log2m):
    for N in bl_sizes(log2m):
        t = bl.chirp_regs_layout(N)
        r = t.regs
        assert t.M == 1 << log2m and 4 * N > t.M >= 2 * N
        assert (r["N1"], r["N2"]) == fl.large_split(t.M)
        assert t.rows_a == r["N1"] // 2
        assert all(s <= TWO_A_SM for s in t.smem), t.smem
        assert t.threads == (r["threads_a"], 256, r["threads_a"])
        assert t.tiles[2] * r["B"] == r["N2"]
        # Pass C copies 16 values a thread of a batch's run.
        assert r["N1"] * r["B"] == 16 * t.threads[2]


def copied_pieces(N, width):
    """Pass A's copies of every tile, as (tile, row, byte) of the pieces
    its prefetch issues: rows below min(M1 / 2, ceil((N - c0) / M2)),
    pieces whose first sample is below N."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M2, C = r["N2"], r["C"]
    out = []
    for j in range(r["tiles_a"]):
        c0 = j * C
        rows = min(t.rows_a, -(-(N - c0) // M2))
        q = np.arange(rows * (2 * C // width))
        row, byte = q // (2 * C // width), q % (2 * C // width) * width
        keep = row * M2 + c0 + byte // 2 < N
        out.append((j, row[keep], byte[keep]))
    return out


@pytest.mark.parametrize("log2m", LOG2M)
@pytest.mark.parametrize("width", [4, 8, 16])
def test_bl_pass_a_copies_every_sample_below_n_once(log2m, width):
    for N in bl_sizes(log2m):
        if (2 * N) % width:
            continue
        t = bl.chirp_regs_layout(N)
        M2, C = t.regs["N2"], t.regs["C"]
        seen = np.zeros(t.M, np.int64)
        for j, row, byte in copied_pieces(N, width):
            for b in range(0, width, 2):
                np.add.at(seen, row * M2 + j * C + (byte + b) // 2, 1)
            # Each piece lands inside the tile's half slot.
            dst = ring_offset(t.regs, row, byte >> 4) + (byte & 15)
            assert (dst + width <= t.rows_a * 2 * C).all()
        assert (seen[:N] == 1).all() and (seen[N:] == 0).all()


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_rows_past_half_hold_no_sample(log2m):
    """N <= M / 2: every sample is in a row n1 < M1 / 2, so pass 0's
    slots k >= 8 (rows t + k TF1 >= M1 / 2) are zero."""
    for N in bl_sizes(log2m):
        t = bl.chirp_regs_layout(N)
        assert (N - 1) // t.regs["N2"] < t.rows_a
        assert 8 * t.regs["TF1"] == t.rows_a


@pytest.mark.parametrize("N", [8194, 16382, 20002, 99998, 499998])
def test_bl_chirp_table_is_a_in_the_threads_order(N):
    t = bl.chirp_regs_layout(N)
    r = t.regs
    tab = bl.chirp_regs_table(N)
    assert tab.shape == (t.M // 2,) and tab.dtype == np.complex64
    _, a, _ = fb.bluestein_constants(N, t.M)
    col, row = fl.thread_map(t.M)
    idx = np.arange(t.M // 2)
    tid = idx % r["threads_a"]
    k = idx // r["threads_a"] % 8
    s = idx // (8 * r["threads_a"]) % r["subs"]
    j = idx // (8 * r["threads_a"] * r["subs"])
    n = ((row[tid] + k * r["TF1"]) * r["N2"] + j * r["C"] + s * r["B"]
         + col[tid])
    # The inverse: every n < M / 2 once, a[n] below N and 0 above.
    assert np.array_equal(np.sort(n), np.arange(t.M // 2))
    np.testing.assert_array_equal(tab[n < N], a[n[n < N]])
    assert (tab[n >= N] == 0).all()


@pytest.mark.parametrize("N", [8194, 99998, 2 ** 21])
def test_bl_spectrum_table_by_element(N):
    t = bl.chirp_regs_layout(N)
    M1, M2 = t.regs["N1"], t.regs["N2"]
    got = bl.spectrum_regs_table(N)
    _, _, B = fb.bluestein_constants(N, t.M)
    want = (B / np.float32(t.M)).astype(np.complex64)
    q = np.arange(M2)
    k2 = pass_bin(M2, q)
    k1 = np.arange(M1)[:, None]
    np.testing.assert_array_equal(got, want[k1 + M1 * k2[None, :]])


def run_slot(r, rr, m2):
    """The stage (and ring) slot of row rr's value m2 in pass B."""
    return (m2 // r["B"]) * r["GS"] + rr * r["B"] + m2 % r["B"]


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_pass_b_stores_are_the_batch_major_order(log2m):
    """Pass B's stage slot of (row rr, m2) and the store that reads it
    (e -> run e / RUN at e mod RUN, scratch at k0 B + (e / RUN) M1 B + e
    mod RUN) put value (k1, m2) at scratch_index(M, k1, m2): every value
    of the frame once, whole runs of B2 B values."""
    M = 1 << log2m
    r = fl.regs_layout(M)
    M1, M2, B, B2, RUN, GS = (r["N1"], r["N2"], r["B"], r["B2"], r["run"],
                              r["GS"])
    rr, m2 = np.meshgrid(np.arange(B2), np.arange(M2), indexing="ij")
    slot = run_slot(r, rr, m2)
    assert len(np.unique(slot)) == B2 * M2
    e = np.arange(B2 * M2)
    g, off = e // RUN, e % RUN
    src = g * GS + off
    assert np.array_equal(np.sort(src), np.sort(slot.ravel()))
    where = {s: (a, b) for s, a, b in zip(slot.ravel(), rr.ravel(),
                                          m2.ravel())}
    seen = np.zeros(M, np.int64)
    for k0 in (0, M1 - B2):
        pos = k0 * B + g * M1 * B + off
        row, col = np.array([where[s] for s in src]).T
        np.testing.assert_array_equal(
            pos, fl.scratch_index(M, k0 + row, col))
        np.add.at(seen, pos, 1)
    for k0 in range(0, M1, B2):
        np.add.at(seen, k0 * B + g * M1 * B + off, 1)
    # Over all row tiles each value once (the two above twice more).
    assert (seen >= 1).all()
    assert RUN * 8 >= 32 and (RUN & (RUN - 1)) == 0


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_pass_b_stage_is_free_of_bank_conflicts(log2m):
    """Pass B's stage writes (thread (rr, t) writes m2 = t + rev_bits(q)
    TF2, one q an instruction): each half-warp's 16 float2 on distinct
    banks."""
    r = fl.regs_layout(1 << log2m)
    TF = r["TF2"]
    for q in range(16):
        for h in range(0, 256, 16):
            tid = np.arange(h, h + 16)
            rr, t = tid // TF, tid % TF
            slot = run_slot(r, rr, t + rev_bits(q, 4) * TF)
            words = np.concatenate([2 * slot, 2 * slot + 1])
            assert wavefronts(words) == 1, (log2m, q, h)


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_pass_c_copies_fill_the_exchange(log2m):
    """Pass C's copies (value e of the batch's run to col_index(e mod B,
    e / B), 16 a thread) fill each column's M1 exchange slots once, and
    thread (c, t)'s pass-0 reads t + k TF1 find (k1, c)."""
    M = 1 << log2m
    r = fl.regs_layout(M)
    M1, B, TF = r["N1"], r["B"], r["TF1"]
    threads = r["threads_a"]
    e = np.arange(16 * threads)
    dst = col_index(r, e % B, e // B)
    assert len(np.unique(dst)) == M1 * B
    assert dst.max() < B * r["XS"]
    col, row = fl.thread_map(M)
    k = np.arange(16)
    reads = col_index(r, col[:, None], row[:, None] + k[None, :] * TF)
    held = dict(zip(dst, e))
    got = np.vectorize(held.get)(reads)
    np.testing.assert_array_equal(got % B, np.broadcast_to(col[:, None],
                                                           got.shape))
    np.testing.assert_array_equal(got // B, row[:, None] + k * TF)


@pytest.mark.parametrize("log2m", LOG2M)
def test_bl_pass_c_keeps_each_bin_below_n_once(log2m):
    """Over every batch, thread and slot, the bins m = m2 + M2 m1 below N
    are written once, and a column keeps at most half of its outputs."""
    M = 1 << log2m
    r = fl.regs_layout(M)
    M1, M2, B, TF = r["N1"], r["N2"], r["B"], r["TF1"]
    col, row = fl.thread_map(M)
    k = np.arange(16)
    m1 = pass_bin(M1, last_element(M1, row[:, None], k[None, :]))
    for N in bl_sizes(log2m):
        seen = np.zeros(M, np.int64)
        for j in range(M2 // B):
            m = j * B + col[:, None] + M2 * m1
            np.add.at(seen, m[m < N], 1)
            per_col = [(m[col == c] < N).sum() for c in range(B)]
            assert max(per_col) <= M1 // 2 + 1
        assert (seen[:N] == 1).all()


# --- BL: the three passes thread by thread ---


def bl_tables(N):
    t = bl.chirp_regs_layout(N)
    r = t.regs
    return (pass_twiddles_c64(r["N1"]), pass_twiddles_c64(r["N2"]),
            fl.regs_inter_twiddle(t.M), bl.chirp_regs_table(N),
            bl.spectrum_regs_table(N), header_w16().astype(np.complex64))


def bl_pass_a(raw_f, N, window, tabs, width, load=None):
    """Pass A on one frame, every tile at once, from its ring as the
    pieces of ``width`` bytes fill it: (M,) complex64 scratch. ``load(re,
    im, n)``, where given, makes the samples of sample indices n from the
    ring's dequantized values in place of the window (PFB-BL's polyphase
    sums, tests/test_torch_estimators_chirp_large.py)."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M1, M2, C, B, TF = r["N1"], r["N2"], r["C"], r["B"], r["TF1"]
    tw1, _, inter, chirp, _, w16 = tabs
    tiles = M2 // C
    ring = np.zeros((tiles, t.rows_a * 2 * C), np.uint8)
    for j, row, byte in copied_pieces(N, width):
        for b in range(width):
            dst = ring_offset(r, row, byte >> 4) + (byte & 15) + b
            ring[j, dst] = raw_f[row * 2 * M2 + 2 * j * C + byte + b]
    col, th = fl.thread_map(t.M)
    tid = np.arange(r["threads_a"])
    k = np.arange(8)
    rows = th[:, None] + k[None, :] * TF
    scratch = np.full(t.M, np.nan, np.complex64)
    e = np.arange(B * M1)
    j = np.arange(tiles)[:, None, None]
    for s in range(r["subs"]):
        c = s * B + col
        byte = 2 * c[:, None]
        addr = ring_offset(r, rows, byte >> 4) + (byte & 15)
        n = rows[None] * M2 + j * C + c[None, :, None]
        re = ring[:, addr].astype(np.float32) - np.float32(127)
        im = ring[:, addr + 1].astype(np.float32) - np.float32(127)
        if load is not None:
            re, im = load(re, im, n)
        elif window is not None:
            w = np.asarray(window, np.float32)[np.minimum(n, N - 1)]
            re, im = re * w, im * w
        a = chirp[((j * r["subs"] + s) * 8 + k[None, None, :])
                  * r["threads_a"] + tid[None, :, None]]
        v = np.zeros((tiles, len(tid), 16), np.complex64)
        v[..., :8] = np.where(n < N, (re + 1j * im).astype(np.complex64) * a,
                              0)
        cc = np.broadcast_to(col, v.shape[:-1])
        y = batch_transform(v, th, lambda el: col_index(r, cc, el), M1, tw1,
                            w16, B * r["XS"])
        k16 = np.arange(16)
        k1 = pass_bin(M1, last_element(M1, th[:, None], k16[None, :]))
        xs = np.full((tiles, B * r["XS"]), np.nan, np.complex64)
        xs[:, col_index(r, col[:, None], k1)] = y
        run = (np.arange(tiles)[:, None] * (C // B) + s) * M1 * B + e
        scratch[run] = xs[:, col_index(r, e % B, e // B)] * inter[run]
    return scratch


class RowTable:
    """A (rows, M2) table indexed by element for every row at once."""

    def __init__(self, table):
        self.table = table

    def __getitem__(self, idx):
        return self.table[:, idx]


def bl_pass_b(scratch_f, N, tabs):
    """Pass B on one frame: every row from the ring, the forward passes,
    the turn, the transposed passes, through the stage back to scratch."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M1, M2, B, B2, TF = r["N1"], r["N2"], r["B"], r["B2"], r["TF2"]
    _, tw2, inter, _, spectrum, w16 = tabs
    tid = np.arange(256)
    rr, th = tid // TF, tid % TF
    n2 = th[:, None] + np.arange(16)[None, :] * TF
    v = ring_b(scratch_f, r)[:, ring_index(r, rr[:, None], n2)]
    v = v.reshape(M1, TF, 16)                # row k0 + rr = k1
    t_ = np.arange(TF)
    v = dif_regs(v, w16)
    xbuf = np.full((M1, pad(M2 - 1) + 1), np.nan, np.complex64)
    for q in range(16):
        k1 = rev_bits(q, 4)
        xbuf[:, pad(t_ + k1 * TF)] = (v[..., q] * tw2[k1 * TF + t_] if k1
                                      else v[..., q])
    forward_passes(xbuf, M2, tw2, w16, t_)
    last_pass_turn(xbuf, M2, tw2, w16, t_, RowTable(spectrum))
    z = transposed_passes(xbuf, M2, tw2, w16, t_)     # (M1, TF, 16)
    out = np.full(t.M, np.nan, np.complex64)
    k1 = np.arange(M1)
    stage = np.full((M1 // B2, (M2 // B) * r["GS"]), np.nan, np.complex64)
    for q in range(16):
        m2 = t_ + rev_bits(q, 4) * TF
        stage[(k1 // B2)[:, None], run_slot(r, (k1 % B2)[:, None],
                                            m2[None, :])] = z[..., q]
    e = np.arange(B2 * M2)
    g, off = e // r["run"], e % r["run"]
    for k0 in range(0, M1, B2):
        pos = k0 * B + g * M1 * B + off
        out[pos] = stage[k0 // B2, g * r["GS"] + off] * inter[pos]
    return out


def bl_pass_c(scratch_f, N, tabs):
    """Pass C on one frame: every batch of B columns, its run copied into
    the exchange, the column transforms; |.|^2 (batches, threads, 16) in
    float32."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M1, M2, B, TF = r["N1"], r["N2"], r["B"], r["TF1"]
    tw1, _, _, _, _, w16 = tabs
    batches = M2 // B
    e = np.arange(M1 * B)
    x = np.full((batches, B * r["XS"]), np.nan, np.complex64)
    x[:, col_index(r, e % B, e // B)] = scratch_f.reshape(batches, M1 * B)
    col, th = fl.thread_map(t.M)
    v = x[:, col_index(r, col[:, None],
                       th[:, None] + np.arange(16)[None, :] * TF)]
    cc = np.broadcast_to(col, v.shape[:-1])
    y = batch_transform(v, th, lambda el: col_index(r, cc, el), M1, tw1, w16,
                        B * r["XS"])
    return (y.real * y.real + y.imag * y.imag).astype(np.float32)


def bl_transcription(raw, n_valid, window=None, width=4):
    """BL's three passes and the sum of their partial rows on the grid
    regs_grid gives for RESIDENT blocks of each pass: (N,) float32."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M1, M2, B = r["N1"], r["N2"], r["B"]
    tabs = bl_tables(N)
    _, _, group_c = bl.regs_grid(F, N, (RESIDENT,) * 3)
    scratch = {}
    for f in range(min(F, n_valid)):
        scratch[f] = bl_pass_b(bl_pass_a(raw[f], N, window, tabs, width), N,
                               tabs)
    col, th = fl.thread_map(t.M)
    m1 = pass_bin(M1, last_element(M1, th[:, None], np.arange(16)[None, :]))
    m = (np.arange(M2 // B)[:, None, None] * B + col[None, :, None]
         + M2 * m1[None])
    rows = []
    for g in range(-(-F // group_c)):
        acc = np.zeros(m.shape, np.float32)
        for f in range(g * group_c, min((g + 1) * group_c, F, n_valid)):
            acc += bl_pass_c(scratch[f], N, tabs)
        row = np.full(t.row, np.nan, np.float32)
        row[m[m < N]] = acc[m < N]
        rows.append(row)
    return sum_rows(rows)[:N]


@pytest.mark.parametrize("N,F,n_valid,window,width", [
    (8194, 3, 3, None, 4), (16382, 2, 2, "hann", 4),
    (16384, 4, 3, None, 16), (12286, 2, 1, "blackman", 4)])
def test_bl_transcription_float32_against_golden(N, F, n_valid, window,
                                                 width):
    raw = frames(F, N, N + F)
    w = None if window is None else make_window(window, N)
    got = bl_transcription(raw, n_valid, w, width)
    assert got.shape == (N,) and np.isfinite(got).all()
    gold = golden(raw, n_valid, w)
    assert max_rel(got, gold) < budget(raw, n_valid, w,
                                       bl.chirp_large_reference, gold)


def test_bl_grid_and_rows():
    """regs_grid's groups from the tiles of each pass; pass C's group sets
    the partial rows (one at 2^21 F=8: written as the output)."""
    assert bl.regs_grid(8, 2 ** 21, (RESIDENT,) * 3) == (8, 8, 8)
    assert bl.regs_grid(256, 16382, (RESIDENT,) * 3) == (16, 8, 16)
    assert bl.regs_grid(64, 99998, (RESIDENT,) * 3) == (8, 16, 16)


# --- ML: split, layouts, plans ---


def test_ml_split_of_every_eligible_n():
    assert len(ML_SIZES) == 1192
    n1s, n2s = [], []
    for N in ML_SIZES:
        n1, n2 = ml.ml_split(N)
        assert n1 * n2 == N and n2 % 2 == 0
        assert fm.smooth7(n1) and fm.smooth7(n2)
        n1s.append(n1)
        n2s.append(n2)
    assert min(n1s) == 49 and max(n1s) == 2025 and max(n2s) == 6250


@pytest.mark.parametrize("N,split", [
    (20000, (125, 160)), (49152, (192, 256)), (100000, (250, 400)),
    (10 ** 6, (1000, 1000)), (16464, (147, 112))])
def test_ml_split_table(N, split):
    assert ml.ml_split(N) == split


def read_ml_plan(ints, max_n, threads=256):
    """read_ml_plan of the source, in Python."""
    P = fm.MAX_PASSES
    n, row, passes, tf, lanes = ints[:5]
    per = [ints[5 + i * P:5 + (i + 1) * P] for i in range(5)]
    radix, stride, magic, twoff, rounds = per
    ok = (2 <= passes <= P and 2 <= n <= max_n and tf >= 1 and lanes >= 1
          and tf * lanes <= threads and lanes & (lanes - 1) == 0)
    L, off = n, 0
    for j in range(passes):
        R = radix[j]
        ok = (ok and R in fm.RADICES and L % R == 0 and stride[j] == L // R
              and twoff[j] == off and rounds[j] == -(-(n // R) // tf)
              and magic[j] % (1 << 32) == (0 if L // R == 1
                                           else -(-(1 << 32) // (L // R))))
        if j < passes - 1:
            off += L
        L //= R
    return ok and L == 1


def test_ml_layout_of_every_eligible_n():
    """Both plans pass read_ml_plan, every block fits two an SM, pass B's
    sums fit their register class, pass A's threads are C columns of
    256 / C."""
    classes = set()
    for N in ML_SIZES:
        t = ml.ml_layout(N)
        a, b = t.launches()
        assert read_ml_plan(a.ints(), 2048) and read_ml_plan(b.ints(), 16384)
        assert a.tf * a.lanes == 256 and a.lanes == t.cols
        assert t.threads == (256, 256)
        assert max(t.smem) <= ml.TILE_SMEM <= TWO_A_SM
        assert t.acc <= fm.RING_ACC[-1]
        assert t.n2p % t.cols == 0 and 0 <= t.n2p - t.N2 < t.cols
        classes.add(t.which_b)
    assert classes == {ml.PASS_B_SMALL, ml.PASS_B_LARGE}


def test_ml_division_constants_are_exact_for_every_plan():
    """umulhi(b, magic(S)) = b / S for every butterfly b of every pass that
    takes it (pass A's middle passes, pass B's passes but the last) of
    both plans of every N."""
    for N in ML_SIZES:
        t = ml.ml_layout(N)
        for plan, first in ((t.plan1, 1), (t.plan2, 0)):
            n = int(np.prod(plan))
            for (L, S), R in list(zip(fm.plan_spans(plan), plan))[first:-1]:
                b = np.arange(n // R, dtype=np.uint64)
                got = (b * np.uint64(fm.magic(S))) >> np.uint64(32)
                assert (got == b // np.uint64(S)).all(), (N, S)


def test_ml_thread_indices_cover_each_butterfly_once():
    """Pass A: thread tid is column tid mod C, column thread tid / C; its
    butterflies b = t + i tf (i < rounds) cover each of every column's
    n1 / R once per pass. Pass B: lane r = tid / tf of lanes rows."""
    for N in ML_SIZES[::37] + ML_SIZES[-1:]:
        t = ml.ml_layout(N)
        a, b = t.launches()
        tid = np.arange(256)
        c, th = tid & (t.cols - 1), tid >> t.log2c
        for R, rounds in zip(a.plan, a.rounds):
            bb = th[:, None] + np.arange(rounds)[None, :] * a.tf
            live = bb < t.N1 // R
            pairs = set(zip(np.broadcast_to(c[:, None], bb.shape)[live],
                            bb[live]))
            assert len(pairs) == live.sum() == t.cols * (t.N1 // R)
        rr = tid // b.tf
        assert rr.max() + 1 == b.lanes


def test_ml_scratch_order_and_inverse():
    for N in (16464, 20000, 100000, 10 ** 6):
        t = ml.ml_layout(N)
        k1, n2 = np.meshgrid(np.arange(t.N1), np.arange(t.N2), indexing="ij")
        pos = ml.ml_scratch_index(N, k1, n2)
        assert len(np.unique(pos)) == N and pos.max() < t.N1 * t.n2p
        # The inverse: (k1, n2) back from the position.
        tile, rest = pos // (t.N1 * t.cols), pos % (t.N1 * t.cols)
        np.testing.assert_array_equal(rest // t.cols, k1)
        np.testing.assert_array_equal(tile * t.cols + rest % t.cols, n2)
        tab = ml.ml_inter_twiddle(N)
        np.testing.assert_array_equal(
            tab[pos], ml.inter_twiddle(N, t.N1, t.N2))
        assert (np.delete(tab, pos.ravel()) == 0).all()


def rows_copies(t, k0):
    """Pass B's prefetch of rows [k0, k0 + lanes): (row, column) of each
    value it copies (two a 16-byte piece), pieces of rows past N1 not
    copied; and the scratch positions they come from."""
    C, lanes = t.cols, t.lanes
    valid = min(lanes, t.N1 - k0)
    per_run = lanes * C // 2
    q = np.arange((t.n2p // C) * per_run)
    h, e = q // per_run, (q % per_run) * 2
    rr = e // C
    keep = rr < valid
    h, e, rr = h[keep], e[keep], rr[keep]
    col = h * C + e % C
    src = (h * t.N1 + k0) * C + e
    return (np.concatenate([rr, rr]), np.concatenate([col, col + 1]),
            np.concatenate([src, src + 1]))


@pytest.mark.parametrize("N", [16464, 20000, 49152, 100000, 10 ** 6,
                               4167450])
def test_ml_pass_b_copies_each_value_of_its_rows_once(N):
    t = ml.ml_layout(N)
    for k0 in (0, (t.N1 - 1) // t.lanes * t.lanes):
        rr, col, src = rows_copies(t, k0)
        valid = min(t.lanes, t.N1 - k0)
        assert len(set(zip(rr, col))) == len(rr) == valid * t.n2p
        live = col < t.N2
        np.testing.assert_array_equal(
            src[live], ml.ml_scratch_index(N, k0 + rr[live], col[live]))


@pytest.mark.parametrize("N,ptr,width", [
    (20000, 0, 16), (20000, 4, 4), (10 ** 6, 0, 16), (16464, 8, 8),
    (4167450, 0, 4), (100000, 0, 16)])
def test_ml_copy_width(N, ptr, width):
    assert ml.ml_copy_width(N, ptr) == width


def test_ml_copy_width_refuses_frames_below_4_bytes():
    with pytest.raises(ValueError):
        ml.ml_copy_width(20000, 2)


@pytest.mark.parametrize("N,most", [
    (20000, 1), (49152, 1), (100000, 1), (10 ** 6, 1), (350000, 1),
    (4167450, 2), (2025000, 2), (1882384, 4)])
def test_ml_pass_a_exchange_banks(N, most):
    """Pass A's exchange (element e of column c at e C + c; thread tid
    column tid mod C): a half-warp's accesses are C adjacent columns of
    16 / C butterflies. At C = 16 every pass's reads and writes fall on
    distinct banks; at C = 8 and 4 the butterflies of a half-warp whose
    elements are not adjacent (a block boundary, the last pass's stride R)
    can share banks, up to 4-way at C = 4 (1882384), 70% of accesses or
    more still conflict-free."""
    t = ml.ml_layout(N)
    C = t.cols
    a, _ = t.launches()
    spans = fm.plan_spans(t.plan1)
    ways = []
    for j, ((L, S), R) in enumerate(zip(spans, t.plan1)):
        for i in range(a.rounds[j]):
            for h in range(0, 256, 16):
                tid = np.arange(h, h + 16)
                c, b = tid & (C - 1), (tid >> t.log2c) + i * a.tf
                live = b < t.N1 // R
                if not live.any():
                    continue
                base = (b // S) * R * S + b % S
                for n1 in range(R):
                    e = (base + n1 * S)[live] * C + c[live]
                    ways.append(wavefronts(np.concatenate([2 * e,
                                                           2 * e + 1])))
    assert max(ways) == most
    assert np.mean(np.asarray(ways) == 1) >= 0.7


# --- ML: the two passes thread by thread ---


def ml_tables(N, dtype):
    t = ml.ml_layout(N)
    if dtype == np.complex128:
        def tw(plan):
            parts = []
            for L, S in fm.plan_spans(plan)[:-1]:
                kn = (np.arange(L // S)[:, None] * np.arange(S)[None, :]) % L
                parts.append(np.exp(-2j * np.pi * kn / L).ravel())
            return np.concatenate(parts)
        k1, n2 = np.meshgrid(np.arange(t.N1), np.arange(t.N2),
                             indexing="ij")
        inter = np.zeros(t.N1 * t.n2p, complex)
        inter[ml.ml_scratch_index(N, k1, n2)] = np.exp(
            -2j * np.pi * (k1 * n2 % N) / N)
        return tw(t.plan1), tw(t.plan2), inter
    conv = [fm.plan_twiddles(p) for p in (t.plan1, t.plan2)]
    return tuple((c[:, 0] + 1j * c[:, 1]).astype(dtype) for c in conv) + (
        ml.ml_inter_twiddle(N).astype(dtype),)


def plan_ints(launch):
    ints = launch.ints()
    P = fm.MAX_PASSES
    return {name: ints[5 + i * P:5 + (i + 1) * P] for i, name in
            enumerate(("radix", "stride", "magic", "twoff", "rounds"))}


def umulhi(b, m):
    return ((b.astype(np.uint64) * np.uint64(m % (1 << 32)))
            >> np.uint64(32)).astype(np.int64)


def ml_pass_a(raw_f, N, window, tabs, dtype):
    """Pass A on one frame, every tile at once: the ring (the pieces of
    columns below N2), pass 0 from it, the middle passes by the division
    constants, the last pass to scratch by bin_of times the twiddle."""
    t = ml.ml_layout(N)
    C, N1, N2, n2p = t.cols, t.N1, t.N2, t.n2p
    a, _ = t.launches()
    per = plan_ints(a)
    tw1, _, inter = tabs
    tiles = n2p // C
    raw2 = np.zeros((N1, n2p, 2), np.uint8)
    raw2[:, :N2] = raw_f.reshape(N1, N2, 2)
    ring = raw2.reshape(N1, tiles, C, 2).transpose(1, 0, 2, 3)  # tile rows
    x = np.full((tiles, N1, C), np.nan, dtype)
    cols = np.arange(C)
    w = None if window is None else np.asarray(window, np.float32)
    R, S = per["radix"][0], per["stride"][0]
    for i in range(per["rounds"][0]):
        b = np.arange(a.tf) + i * a.tf
        b = b[b < S]
        rows = b[:, None] + np.arange(R)[None, :] * S          # (b, R)
        re = ring[..., 0][:, rows, :].astype(np.float32) - np.float32(127)
        im = ring[..., 1][:, rows, :].astype(np.float32) - np.float32(127)
        if w is not None:
            n2 = np.arange(tiles)[:, None, None, None] * C + cols
            ww = w[np.minimum(rows[None, :, :, None] * N2 + n2, N - 1)]
            re, im = re * ww, im * ww
        v = dft_natural(np.moveaxis((re + 1j * im).astype(dtype), 2, -1))
        k1 = np.arange(R)
        tw = np.where(k1 == 0, 1, tw1[k1[None, :] * S + b[:, None]])
        x[:, b[:, None] + k1[None, :] * S, :] = np.moveaxis(
            v * tw[None, :, None, :].astype(dtype), -1, 2)
    for j in range(1, len(a.plan) - 1):
        R, S, m, off = (per[k][j] for k in ("radix", "stride", "magic",
                                            "twoff"))
        for i in range(per["rounds"][j]):
            b = np.arange(a.tf) + i * a.tf
            b = b[b < N1 // R]
            block = umulhi(b, m)
            n2 = b - block * S
            idx = (block * R * S + n2)[:, None] + np.arange(R)[None, :] * S
            v = dft_natural(np.moveaxis(x[:, idx, :], 3, 2))
            k1 = np.arange(R)
            tw = np.where(k1 == 0, 1, tw1[off + k1[None, :] * S
                                          + n2[:, None]])
            x[:, idx, :] = np.moveaxis(v * tw[None, :, None, :].astype(dtype),
                                       2, 3)
    R = a.plan[-1]
    bin_of = ml.bin_of_element(t.plan1)
    out = np.full(N1 * n2p, np.nan, dtype)
    live = np.arange(tiles)[:, None] * C + cols[None, :] < N2
    for i in range(a.rounds[-1]):
        b = np.arange(a.tf) + i * a.tf
        b = b[b < N1 // R]
        idx = b[:, None] * R + np.arange(R)[None, :]
        v = dft_natural(np.moveaxis(x[:, idx, :], 3, 2))    # (tile, b, C, R)
        e = ((np.arange(tiles)[:, None, None, None] * N1
              + bin_of[idx][None, :, None, :]) * C
             + cols[None, None, :, None])
        keep = np.broadcast_to(live[:, None, :, None], e.shape)
        out[e[keep]] = (v * inter[e])[keep]
    return out


def ml_pass_b(scratch_f, N, tabs, dtype):
    """Pass B on one frame, every row tile at once: the rows as the
    copies fill the slot, the passes but the last in place by the division
    constants, the last pass's |X|^2 at each thread's elements:
    (N1, N2) by element."""
    t = ml.ml_layout(N)
    _, b_launch = t.launches()
    per = plan_ints(b_launch)
    _, tw2, _ = tabs
    N1, N2 = t.N1, t.N2
    rows = np.full((N1, t.n2p), np.nan, dtype)
    for k0 in range(0, N1, t.lanes):
        rr, col, src = rows_copies(t, k0)
        rows[k0 + rr, col] = scratch_f[src]
    x = rows[:, :N2].copy()
    tf = b_launch.tf
    for j in range(len(t.plan2) - 1):
        R, S, m, off = (per[k][j] for k in ("radix", "stride", "magic",
                                            "twoff"))
        for i in range(per["rounds"][j]):
            b = np.arange(tf) + i * tf
            b = b[b < N2 // R]
            block = umulhi(b, m)
            n2 = b - block * S
            idx = (block * R * S + n2)[:, None] + np.arange(R)[None, :] * S
            v = dft_natural(x[:, idx])
            k1 = np.arange(R)
            tw = np.where(k1 == 0, 1, tw2[off + k1[None, :] * S
                                          + n2[:, None]])
            x[:, idx] = v * tw.astype(dtype)
    R = t.plan2[-1]
    power = np.full((N1, N2), np.nan, x.real.dtype)
    for i in range(b_launch.acc_class // R):
        b = np.arange(tf) + i * tf
        b = b[b < N2 // R]
        idx = b[:, None] * R + np.arange(R)[None, :]
        v = dft_natural(x[:, idx])
        power[:, idx] = v.real ** 2 + v.imag ** 2
    return power


def ml_transcription(raw, n_valid, window=None, dtype=np.complex64):
    """ML's two passes and the sum of their partial rows (pass B's grid
    for RESIDENT blocks): (N,) float32 (float64 for complex128)."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = ml.ml_layout(N)
    tabs = ml_tables(N, dtype)
    group_b = fl.large_group(F, t.tiles[1], RESIDENT)
    order2 = fm.element_of_bin(t.plan2, np.arange(t.N2))
    real = np.float64 if dtype == np.complex128 else np.float32
    rows = []
    for g in range(-(-F // group_b)):
        acc = np.zeros((t.N1, t.N2), real)
        for f in range(g * group_b, min((g + 1) * group_b, F, n_valid)):
            acc += ml_pass_b(ml_pass_a(raw[f], N, window, tabs, dtype), N,
                             tabs, dtype)
        row = np.zeros(t.row, real)
        # bin k1 + N1 k2 from element order2[k2] of row k1
        row[:N] = acc[:, order2].T.reshape(-1)
        rows.append(row)
    if dtype == np.complex128:
        return np.sum(rows, axis=0)[:N]
    return sum_rows(rows)[:N]


@pytest.mark.parametrize("N", [16464, 18750, 20000])
def test_ml_transcription_float64_is_the_dft(N):
    raw = frames(2, N, N + 3)
    got = ml_transcription(raw, 2, dtype=np.complex128)
    X = np.fft.fft(dequantize(raw, None, np.complex128), axis=1)
    want = (X.real ** 2 + X.imag ** 2).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * want.max())


@pytest.mark.parametrize("N,F,n_valid,window", [
    (20000, 3, 3, "hann"), (16464, 2, 1, None), (18750, 9, 9, None),
    (24000, 2, 2, "blackman")])
def test_ml_transcription_float32_against_golden(N, F, n_valid, window):
    raw = frames(F, N, 2 * N + F)
    w = None if window is None else make_window(window, N)
    got = ml_transcription(raw, n_valid, w)
    assert got.shape == (N,) and np.isfinite(got).all()
    gold = golden(raw, n_valid, w)
    assert max_rel(got, gold) < budget(raw, n_valid, w,
                                       ml.fused_psd_mixed_large_reference,
                                       gold)


# --- the sources ---


def test_ml_constants_are_the_sources():
    text = (CSRC / "fused_psd_mixed_large_streams.cuh").read_text()
    assert int(re.search(r"constexpr int kColsThreads = (\d+);",
                         text).group(1)) == ml.COLS_THREADS
    assert int(re.search(r"constexpr int kRowsThreads = (\d+);",
                         text).group(1)) == ml.ROWS_THREADS


def test_bl_register_passes_share_the_large_kernels_header():
    """BL's passes include the large kernel's register passes rather than
    a copy of them."""
    bl_src = (CSRC / "fused_psd_chirp_large.cu").read_text()
    large = (CSRC / "fused_psd_large.cu").read_text()
    for src in (bl_src, large):
        assert '#include "fused_psd_large_regs.cuh"' in src
    for name in ("struct LargeRegs", "col_pass(", "regs_a_rest("):
        assert name not in bl_src and name not in large


# --- the route ---


@pytest.mark.parametrize("log2m", LOG2M)
def test_every_bl_n_takes_the_register_passes(log2m):
    """The route: every even N of BL's band has the register passes'
    layout (the form was ahead of its control at every shape the card
    timed, so no range goes to the control), and a CUDA call launches
    the register passes' entry alone."""
    for N in bl_sizes(log2m):
        assert bl.fused_psd_chirp_large_eligible(N)
        assert bl.chirp_regs_layout(N).log2m == log2m
    import inspect
    src = inspect.getsource(bl.fused_psd_chirp_large)
    assert "rpf_fused_psd_chirp_large(" in src and "control" not in src


def test_every_ml_n_takes_the_division_free_passes():
    import inspect
    assert all(ml.ml_layout(N).N == N for N in ML_SIZES)
    src = inspect.getsource(ml.fused_psd_mixed_large)
    assert "rpf_fused_psd_mixed_large(" in src and "control" not in src


@pytest.mark.parametrize("n2,shape", [
    (112, (16, 16)), (160, (16, 16)), (256, (16, 16)), (400, (32, 8)),
    (1000, (64, 4)), (6250, (256, 1))])
def test_ml_row_shape_rule(n2, shape):
    assert ml.rows_shape(n2, fm.mixed_plan(n2)) == shape



# --- the builds probe ---


@pytest.mark.parametrize("name", sorted(large_awkward_builds.BUILDS))
def test_build_edits_apply_to_the_sources(name):
    """Each build of probes/large_awkward_builds.py edits the shipped
    source as it says: one launch bound each."""
    library, edits = large_awkward_builds.BUILDS[name]
    text = (CSRC / f"{library}.cu").read_text()
    got = large_awkward_builds.build_sources(text, edits)
    assert got != text and got.count("__launch_bounds__") == text.count(
        "__launch_bounds__")


def test_probe_row_shapes_keep_256_threads():
    """rows8 and rows16 keep a block at 256 threads: at most 8 rows, or
    16 wherever they fit beside the shipped shape."""
    for N in ML_SIZES[::11]:
        n2 = ml.ml_layout(N).N2
        plan = fm.mixed_plan(n2)
        tf, lanes = large_awkward_builds.rows8(n2, plan)
        assert lanes <= 8 and tf * lanes == 256
        tf16, lanes16 = large_awkward_builds.rows16(n2, plan)
        assert tf16 * lanes16 == 256 and lanes16 >= ml.rows_shape(n2,
                                                                 plan)[1]


def test_builds_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert large_awkward_builds.main([]) == 1
