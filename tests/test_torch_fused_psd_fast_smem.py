"""K3's Hopper kernel (csrc/fused_psd_fast_smem.cuh: psd_smem_kernel),
transcribed in numpy.

The CUDA kernel runs only on a card (chip_smoke.py); its index arithmetic
is pinned here: the shared-memory plan (read out of the source's
``kSmemPlan``) and the layout it gives at every N, windowed and not; the
register-major weight tiles and the ldmatrix.x4 that reads two of them;
Z's six bf16 split planes, their swizzled rows, the stage-1 stores and
the stage-2 ldmatrix.trans; the raw ring the cp.async copies fill; a bank
model of every ldmatrix and store the design claims free of conflicts;
and the grid rule at F = 400, 104, 1024 and 4096. A transcription that
emulates the kernel lane by lane (its shared memory as a byte array, the
ldmatrix loads and mma.m16n8k16 from per-lane registers, the Z passes)
is held to the plain version (rtol 2e-5, the bound chip_smoke.py holds
the kernel to), and through it to the JAX package's fast kernel in
interpret mode (5e-6, as tests/test_torch_fused_psd_fast.py) and to
tests/golden.py (1e-4, the relaxed tier), at N = 256, 2048 and 8192,
windowed and not, with masked frames.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.ops.kernels import fused_psd as jax_fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff

from golden import golden_accumulate

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
SIZES = sorted(ff.SMEM_PLAN)
KERNEL_VS_PLAIN_RTOL = 2e-5
PLAIN_VS_JAX_RTOL = 5e-6
RELAXED_RTOL = 1e-4
#: An H100 SM's shared memory (228 KB), what each block reserves, and the
#: most one block may use.
SM_SMEM, BLOCK_RESERVED, BLOCK_MAX = 233472, 1024, 232448
SMS = 132

G_, T_ = np.arange(32) >> 2, np.arange(32) & 3      # per lane: g, t
LANE = np.arange(32)


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def golden(raw, n_valid, window=None):
    N = raw.shape[1] // 2
    pwr, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid,
                               window=window)
    return np.fft.ifftshift(pwr)


def source_plan():
    """{N: (unwindowed row, windowed row)} of kSmemPlan in the source."""
    text = (CSRC / "fused_psd_fast_smem.cuh").read_text()
    body = text[text.index("constexpr int kSmemPlan"):]
    body = body[:body.index("};")]
    rows = re.findall(r"\{\{([\d, ]+)\}, \{([\d, ]+)\}\},\s*// (\d+)", body)
    return {int(n): tuple(tuple(int(v) for v in r.split(",")) for r in (a, b))
            for a, b, n in rows}


def z_chunk(row_chunks, n2, c):
    """The 16-byte chunk of Z-plane row n2 holding k1 chunk c
    (``z_chunk`` in the source)."""
    shift = 0 if row_chunks >= 8 else (1 if row_chunks == 4 else 2)
    mask = min(row_chunks, 8) - 1
    return c ^ ((n2 >> shift) & mask)


def z_offset(N, windowed, n2, k1):
    """bf16 element offset of (n2, k1 of the pass) in a Z plane
    (``z_offset`` in the source)."""
    t = ff.smem_layout(N, windowed)
    return (n2 * t["N1Z"] + z_chunk(t["row_chunks"], n2, k1 >> 3) * 8
            + (k1 & 7))


def stage1_blocks(windowed):
    """For each K-stack block b of WR and WI (6 or 12), where the kernel
    takes it from w1's six blocks: (WR block, WI block, WI's sign
    flipped). Block b = 2m + s holds weight term j of the order c0 c1 c2
    (windowed c0 c1 c2 c0 c1 c0): WR's is w1 block 2j + s; WI's is i_j,
    w1 block 2j + 1 negated (s = 0), or r_j, w1 block 2j (s = 1)."""
    order = (0, 1, 2, 0, 1, 0) if windowed else (0, 1, 2)
    return tuple((2 * j + s, 2 * j + 1 - s, s == 0)
                 for j in order for s in (0, 1))


def blocks_per_sm(N, windowed):
    """The blocks an H100 SM holds by shared memory and by the launch
    bounds' register cap (128 a thread: MIN_BLOCKS), at most 2048
    threads."""
    t = ff.smem_layout(N, windowed)
    by_smem = SM_SMEM // (t["bytes"] + BLOCK_RESERVED)
    return min(by_smem, t["min_blocks"], 2048 // t["threads"])


# --- the plan and the layout ---

def test_plan_is_the_sources():
    assert source_plan() == ff.SMEM_PLAN


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", SIZES)
def test_layout_fits_and_partitions_the_block(N, windowed):
    t = ff.smem_layout(N, windowed)
    n1, n2 = ff.fast_split(N)
    assert t["bytes"] <= BLOCK_MAX
    assert t["items"] % t["ZP"] == 0 and t["IPP"] % t["warps"] == 0
    assert t["IPW"] >= 1 and t["N1Z"] % 16 == 0
    assert t["copies"] * 16 * t["threads"] == 2 * N
    parts = [(0, t["OFF_W2"]), (t["OFF_W2"], t["OFF_Z"]),
             (t["OFF_Z"], t["OFF_RING"]), (t["OFF_RING"], t["OFF_WIN"]),
             (t["OFF_WIN"], t["OFF_BAR"]), (t["OFF_BAR"], t["bytes"])]
    assert [b - a for a, b in parts] == [
        t["W1_BYTES"] * t["s1"], 6 * t["W2_BYTES"] * t["s2"],
        6 * n2 * t["N1Z"] * 2, 2 * n1 * (2 * n2 + 16),
        4 * n1 * (n2 + 4) * windowed, 16]
    # Every part starts 16-byte aligned (bulk copies, cp.async, uint4),
    # the mbarrier 8-byte aligned.
    assert all(a % 16 == 0 for a, _ in parts)
    # From 1024 bins the weights a plan leaves in device memory would not
    # fit beside the rest: each zero of the plan there is forced.
    for flag, size in (("s1", t["W1_BYTES"]), ("s2", 6 * t["W2_BYTES"])):
        if not t[flag] and N >= 1024:
            assert t["bytes"] + size > (
                BLOCK_MAX if t["min_blocks"] == 1
                else SM_SMEM // t["min_blocks"] - BLOCK_RESERVED)


@pytest.mark.parametrize("windowed,want", [
    (False, {256: 16, 512: 8, 1024: 4, 2048: 2, 4096: 1, 8192: 1,
             16384: 1}),
    (True, {256: 16, 512: 8, 1024: 4, 2048: 2, 4096: 1, 8192: 1,
            16384: 1})])
def test_blocks_an_sm(windowed, want):
    """Two blocks of 8 warps an SM at 2048 bins, windowed or not."""
    assert {N: blocks_per_sm(N, windowed) for N in SIZES} == want


def test_resident_weights_at_2048():
    """At 2048 the resident weights are 60 KB, windowed or not: stage 1's
    six distinct blocks 12 KB (WR and WI in full: 24 KB, 48 windowed)
    and the stage-2 planes 48 KB."""
    for windowed in (False, True):
        t = ff.smem_layout(2048, windowed)
        assert (t["W1_BYTES"], 6 * t["W2_BYTES"]) == (12288, 49152)
        assert t["resident"] == 61440


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", [256, 2048, 16384])
def test_stage1_blocks_are_wr_and_wi(N, windowed):
    """Every K-stack block of WR and WI is one of w1's six blocks, WI's
    with its bf16 sign bits flipped where stage1_blocks says."""
    n1, n2 = ff.fast_split(N)
    WR, WI = ff.constants(N, n1, n2, windowed)[:2]
    w1 = ff.constants(N, n1, n2, False)[0]
    blocks = stage1_blocks(windowed)
    assert len(blocks) == WR.shape[0] // n1
    for b, (r, i, flip) in enumerate(blocks):
        np.testing.assert_array_equal(WR[b * n1:(b + 1) * n1],
                                      w1[r * n1:(r + 1) * n1])
        np.testing.assert_array_equal(
            WI[b * n1:(b + 1) * n1],
            w1[i * n1:(i + 1) * n1] ^ np.uint16(0x8000 if flip else 0))


def test_stage1_term_is_the_sources():
    """stage1_term in the source, m < 3 ? m : (m == 4 ? 1 : 0): the
    K-stack's weight terms c0 c1 c2 and, windowed, c0 c1 c2 c0 c1 c0, as
    stage1_blocks reads them."""
    text = (CSRC / "fused_psd_fast_smem.cuh").read_text()
    body = text[text.index("constexpr int stage1_term"):]
    assert re.search(r"return (.*);", body).group(1) \
        == "m < 3 ? m : (m == 4 ? 1 : 0)"
    terms = [m if m < 3 else (1 if m == 4 else 0) for m in range(6)]
    for windowed in (False, True):
        want = [r // 2 for r, _, _ in stage1_blocks(windowed)[::2]]
        assert terms[:len(want)] == want


# --- the weights in register-major order, read by ldmatrix ---

def ldmatrix(smem_words, addr_bytes, trans=False):
    """Emulates ldmatrix.sync.aligned.m8n8.x4.b16 over shared memory given
    as 32-bit words (..., n): lane l gives the byte address of row l & 7
    of matrix l >> 3. Returns (..., 32, 4, 2) uint16: register r of each
    lane, low half first. Without .trans lane i receives row i >> 2,
    elements 2(i & 3), +1; with .trans (row 2(i & 3), column i >> 2) and
    the next row's."""
    halves = smem_words.view(np.uint16)
    out = np.zeros(halves.shape[:-1] + (32, 4, 2), np.uint16)
    for m in range(4):
        rows = np.asarray(addr_bytes[8 * m:8 * m + 8]) // 2     # in halves
        mat = halves[..., rows[:, None] + np.arange(8)]         # (..., 8, 8)
        if trans:
            out[..., m, 0] = mat[..., 2 * T_, G_]
            out[..., m, 1] = mat[..., 2 * T_ + 1, G_]
        else:
            out[..., m, 0] = mat[..., G_, 2 * T_]
            out[..., m, 1] = mat[..., G_, 2 * T_ + 1]
    return out


def b_pair_addresses(base_bytes):
    return base_bytes + (LANE >> 3) * 128 + (LANE & 7) * 16


@pytest.mark.parametrize("K,C", [(32, 16), (96, 32), (64, 64)])
def test_ldmatrix_of_register_major_tiles_is_two_b_fragments(K, C):
    bits = np.random.default_rng(K + C).integers(
        0, 1 << 16, (K, C), dtype=np.uint64).astype(np.uint16)
    frag = ff.pack_b_fragments(bits)                 # (K/16, C/8, 32, 4)
    words = ff.pack_b_ldmatrix(bits).reshape(-1).view(np.uint32)
    for kc in range(K // 16):
        for nt in range(0, C // 8, 2):
            base = ((kc * (C // 8) + nt) * 64) * 4
            regs = ldmatrix(words, b_pair_addresses(base))
            for j in range(2):
                np.testing.assert_array_equal(
                    regs[:, 2 * j:2 * j + 2].reshape(32, 4),
                    frag[kc, nt + j])
            # The device-memory path: word 32 r + lane of the pair.
            w = words[base // 4:base // 4 + 128].reshape(4, 32).T
            np.testing.assert_array_equal(
                w.copy().view(np.uint16).reshape(32, 4, 2), regs)


# --- Z's split planes ---

@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", SIZES)
def test_z_plane_is_a_bijection(N, windowed):
    t = ff.smem_layout(N, windowed)
    n2 = np.arange(t["N2"])[:, None]
    k1 = np.arange(t["N1Z"])[None, :]
    off = z_offset(N, windowed, n2, k1)
    assert sorted(off.ravel()) == list(range(t["ZPLANE"]))
    # A (k1, k1 + 1) pair is one aligned 32-bit word, a k1 chunk of 8
    # one 16-byte row of an ldmatrix matrix.
    assert (off[:, 0::2] % 2 == 0).all()
    assert (off[:, 1::2] == off[:, 0::2] + 1).all()
    assert (off[:, 0::8] % 8 == 0).all()
    assert (np.diff(off.reshape(t["N2"], -1, 8), axis=-1) == 1).all()


def bank_groups(byte_addresses):
    """16-byte bank groups (of the 8 in 128 bytes) that 8 rows hit."""
    return {int(a // 16) % 8 for a in byte_addresses}


def word_conflicts(byte_addresses):
    """The most distinct 32-bit words a warp's access puts on one bank."""
    words = {}
    for a in np.asarray(byte_addresses).ravel():
        words.setdefault(int(a // 4) % 32, set()).add(int(a // 4))
    return max(len(v) for v in words.values())


def z_store_addresses(N, windowed, mtl, ngl, j, h):
    """Byte addresses of the 32 lanes' 32-bit stores of one (j, h) of a
    stage-1 item (plane 0)."""
    n2 = 16 * mtl + G_ + 8 * h
    k1 = 16 * ngl + 8 * j + 2 * T_
    return 2 * z_offset(N, windowed, n2, k1)


def z_ldmatrix_addresses(N, windowed, mtl, c):
    """Byte addresses the 32 lanes give to stage 2's ldmatrix.trans of Z
    plane 0 for k1 tile mtl (of the pass) and n2 chunk c."""
    m = LANE >> 3
    n2 = 16 * c + 8 * (m >> 1) + (LANE & 7)
    return 2 * z_offset(N, windowed, n2, 16 * mtl + 8 * (m & 1))


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", SIZES)
def test_z_accesses_are_free_of_bank_conflicts(N, windowed):
    t = ff.smem_layout(N, windowed)
    for mtl in range(t["N1Z"] // 16):           # stage 2's k1 tiles
        for c in range(t["N2"] // 16):
            addr = z_ldmatrix_addresses(N, windowed, mtl, c)
            for m in range(4):
                assert len(bank_groups(addr[8 * m:8 * m + 8])) == 8
    for mt in range(t["N2"] // 16):             # stage 1's stores
        for ngl in range(t["N1Z"] // 16):
            for j in range(2):
                for h in range(2):
                    assert word_conflicts(z_store_addresses(
                        N, windowed, mt, ngl, j, h)) == 1


def test_weight_ldmatrix_is_free_of_bank_conflicts():
    addr = b_pair_addresses(0)
    for m in range(4):
        assert len(bank_groups(addr[8 * m:8 * m + 8])) == 8


def ring_copies(N, windowed=False):
    """(source, destination) byte offsets of every thread's cp.async
    pieces of a frame, as the kernel's prefetch computes them."""
    t = ff.smem_layout(N, windowed)
    per_row = t["N2"] // 8
    q = np.array([tid + k * t["threads"] for tid in range(t["threads"])
                  for k in range(t["copies"])])
    return 16 * q, (q // per_row) * t["RING_ROW"] + 16 * (q % per_row)


def ring_index(N, n):
    """u16 index in a ring slot of sample n = N2 n1 + n2."""
    t = ff.smem_layout(N, False)
    return (n // t["N2"]) * (t["RING_ROW"] // 2) + n % t["N2"]


@pytest.mark.parametrize("N", SIZES)
def test_ring_copies_fill_each_slot_once(N):
    t = ff.smem_layout(N, False)
    src, dst = ring_copies(N)
    assert sorted(src) == list(range(0, 2 * N, 16))
    assert len(set(dst)) == len(dst) and (dst % 16 == 0).all()
    assert dst.max() + 16 <= t["SLOT"]
    # Each sample lands where the gather reads it.
    n = np.arange(N)
    where = np.empty(2 * N // 16, np.int64)
    where[src // 16] = dst
    np.testing.assert_array_equal(ring_index(N, n) * 2,
                                  where[(2 * n) // 16] + (2 * n) % 16)
    # A warp's copies are 512 contiguous bytes of the frame: whole lines.
    first = src.reshape(t["threads"], t["copies"])[:32, 0]
    assert (np.diff(first) == 16).all()


def gather_addresses(N, windowed, mt, c, qq, second):
    """Byte addresses of a warp's stage-1 u16 gather (element n of the
    pair, or n + one row) and of its window reads."""
    t = ff.smem_layout(N, windowed)
    n1 = 16 * c + 2 * T_ + 8 * (qq >> 1) + second
    n2 = 16 * mt + G_ + 8 * (qq & 1)
    return (2 * (n1 * (t["RING_ROW"] // 2) + n2),
            4 * (n1 * t["WIN_ROW"] + n2))


@pytest.mark.parametrize("N", SIZES)
def test_gather_is_free_of_bank_conflicts(N):
    """The stage-1 gather of the ring (two lanes may share a word) and of
    the window: one word a bank."""
    n1, n2 = ff.fast_split(N)
    for mt in range(n2 // 16):
        for c in range(n1 // 16):
            for qq in range(4):
                for second in (0, 1):
                    ring, win = gather_addresses(N, True, mt, c, qq, second)
                    assert word_conflicts(ring) == 1
                    assert word_conflicts(win) == 1


def test_unpadded_gather_would_conflict():
    """What the padding is for: rows 2t apart of a [n1][n2] frame at
    2048 bins put the four t on one bank."""
    n1 = 2 * T_
    n2 = G_
    assert word_conflicts(2 * (n1 * 64 + n2)) == 4


# --- the grid ---

@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("fps", [400, 104, 1024, 4096])
def test_grid_is_one_wave(N, windowed, fps):
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
    F, chunk = adapt_batch(fps)
    resident = SMS * blocks_per_sm(N, windowed)
    group = fp.k1_group(F, chunk, resident)
    rows = -(-F // group)
    assert chunk % group == 0
    fits = [g for g in range(1, chunk + 1)
            if chunk % g == 0 and -(-F // g) <= resident]
    assert group == (min(fits) if fits else chunk)
    assert rows <= resident or group == chunk


@pytest.mark.parametrize("N,windowed,fps,group", [
    (2048, False, 4096, 16), (2048, False, 400, 2), (2048, True, 400, 2),
    (8192, True, 104, 1), (8192, False, 1024, 8), (16384, False, 256, 2)])
def test_grid_at_the_timed_shapes(N, windowed, fps, group):
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
    F, chunk = adapt_batch(fps)
    assert fp.k1_group(F, chunk, SMS * blocks_per_sm(N, windowed)) == group


# --- the transcription ---

def bf16_f32(bits):
    return ff.bf16_value(bits)


def to_bits(x):
    return ff.bf16_bits(np.asarray(x, np.float32).astype(np.float64))


def split_bits(x, k):
    """Successive bf16 terms of f32 x as bit patterns."""
    out, r = [], np.asarray(x, np.float32)
    for _ in range(k):
        b = to_bits(r)
        out.append(b)
        r = (r - bf16_f32(b)).astype(np.float32)
    return out


def pack(lo, hi):
    return lo.astype(np.uint32) | (hi.astype(np.uint32) << 16)


def mma(d, a, b):
    """mma.m16n8k16: a (..., 32, 4) and b (32, 2) or (..., 32, 2) packed
    bf16 registers, d (..., 32, 4) f32, per lane; the leading axes are
    independent products (frames)."""
    lead = a.shape[:-2]
    A = np.zeros(lead + (16, 16))
    B = np.zeros(b.shape[:-2] + (16, 8))
    for q in range(4):
        for h in range(2):
            A[..., G_ + 8 * (q & 1), 2 * T_ + h + 8 * (q >> 1)] = bf16_f32(
                ((a[..., q] >> (16 * h)) & 0xFFFF).astype(np.uint16))
    for r in range(2):
        for h in range(2):
            B[..., 2 * T_ + h + 8 * r, G_] = bf16_f32(
                ((b[..., r] >> (16 * h)) & 0xFFFF).astype(np.uint16))
    D = A @ B
    for e in range(4):
        d[..., e] = (d[..., e] + D[..., G_ + 8 * (e >> 1), 2 * T_ + (e & 1)]
                     ).astype(np.float32)


def regs_of(ld):
    return pack(ld[..., 0], ld[..., 1])            # (..., 32, 4) uint32


def kernel_transcription(raw, n_valid, chunk, window, resident):
    """The kernel's blocks, passes, items and fragment arithmetic, its
    shared memory an array of words (the Z planes one copy per frame: a
    block's frames are computed side by side here, one after another
    there, and summed in its order); the row sum in float64. Returns the
    sum and the block's frames."""
    F, N = raw.shape[0], raw.shape[1] // 2
    windowed = window is not None
    t = ff.smem_layout(N, windowed)
    N1, N2, ZP, N1Z = t["N1"], t["N2"], t["ZP"], t["N1Z"]
    warps, IPP, IPW = t["warps"], t["IPP"], t["IPW"]
    planes_of = ff.input_planes(windowed)
    nplanes = 6 if windowed else 2
    w1, tw, w2 = ff.smem_constants(N, windowed)
    w1 = w1.reshape(-1).view(np.uint32)
    w2 = w2.reshape(-1).view(np.uint32)
    plane_words = t["W2_BYTES"] // 4
    weights = np.zeros(t["OFF_Z"] // 4 + 1, np.uint32)
    # The resident weights, copied as the bulk copies do.
    if t["s1"]:
        weights[:w1.size] = w1
    if t["s2"]:
        weights[t["OFF_W2"] // 4:t["OFF_W2"] // 4 + w2.size] = w2
    zwords = t["ZPLANE"] // 2

    def b_pair(which, word):
        """The B fragments of two tiles from word `word` of a weight
        array: ldmatrix from shared memory where resident, else the four
        device-memory loads."""
        res, arr, off = {"w1": (t["s1"], w1, 0),
                         "w2": (t["s2"], w2, t["OFF_W2"] // 4)}[which]
        if res:
            return regs_of(ldmatrix(weights,
                                    b_pair_addresses(4 * (off + word))))
        return arr[word:word + 128].reshape(4, 32).T.copy()

    group = fp.k1_group(F, chunk, resident)
    rows = []
    for blk in range(-(-F // group)):
        f0 = blk * group
        fr = np.arange(f0, min(f0 + group, F, n_valid))
        nf = len(fr)
        power = np.zeros((nf, ZP, IPW, warps, 2, 32, 4), np.float32)
        # The ring slot as the cp.async pieces fill it, and the window as
        # the block stores it (padded rows).
        src, dst = ring_copies(N, windowed)
        slot = np.zeros((nf, t["SLOT"]), np.uint8)
        for k in range(16):
            slot[:, dst + k] = raw[fr][:, src + k]
        iq = slot.view(np.uint16).astype(np.int64)       # (nf, SLOT / 2)
        rr = t["RING_ROW"] // 2
        if windowed:
            wrows = np.zeros(N1 * t["WIN_ROW"], np.float32)
            n = np.arange(N)
            wrows[(n // N2) * t["WIN_ROW"] + n % N2] = window
        zp = np.zeros((nf, 3 * t["ZPLANE"]), np.uint32)     # six planes
        for p in range(ZP if nf else 0):
            for warp in range(warps):                       # stage 1
                for q in range(warp, IPP, warps):
                    mt, ng = divmod(q, N1Z // 16)
                    ng += p * (N1Z // 16)
                    yr = np.zeros((2, nf, 32, 4), np.float32)
                    yi = np.zeros((2, nf, 32, 4), np.float32)
                    for c in range(N1 // 16):
                        a = np.zeros((nplanes, nf, 32, 4), np.uint32)
                        for qq in range(4):
                            n1 = 16 * c + 2 * T_ + 8 * (qq >> 1)
                            n2 = 16 * mt + G_ + 8 * (qq & 1)
                            vals = []
                            for h in range(2):
                                m = (n1 + h) * rr + n2
                                re = ((iq[:, m] & 0xFF) - 127).astype(
                                    np.float32)
                                im = ((iq[:, m] >> 8) - 127).astype(
                                    np.float32)
                                if windowed:
                                    w = wrows[(n1 + h) * t["WIN_ROW"] + n2]
                                    vals.append(split_bits(re * w, 3)
                                                + split_bits(im * w, 3))
                                else:
                                    vals.append([to_bits(re), to_bits(im)])
                            for pl in range(nplanes):
                                # windowed planes: a0r a0i a1r a1i a2r a2i
                                src = (pl // 2 + 3 * (pl % 2) if windowed
                                       else pl)
                                a[pl, :, :, qq] = pack(vals[0][src],
                                                       vals[1][src])
                        w = [b_pair("w1", ((k * (N1 // 16) + c) * (N1 // 8)
                                           + 2 * ng) * 64) for k in range(6)]
                        for b, plane in enumerate(planes_of):
                            r, i, flip = stage1_blocks(windowed)[b]
                            wi = w[i] ^ np.uint32(0x80008000 if flip else 0)
                            for j in range(2):
                                mma(yr[j], a[plane], w[r][:, 2 * j:2 * j + 2])
                                mma(yi[j], a[plane], wi[:, 2 * j:2 * j + 2])
                    for j in range(2):
                        for h in range(2):
                            n2 = 16 * mt + G_ + 8 * h
                            k1 = 16 * ng + 8 * j + 2 * T_
                            z = []
                            for e in range(2):
                                ar = yr[j][..., 2 * h + e]
                                ai = yi[j][..., 2 * h + e]
                                c_, s_ = tw[n2, k1 + e, 0], tw[n2, k1 + e, 1]
                                zr = (ar * c_ - ai * s_).astype(np.float32)
                                zi = (ar * s_ + ai * c_).astype(np.float32)
                                z.append((zr, zi,
                                          (zr + zi).astype(np.float32)))
                            at = z_offset(N, windowed, n2,
                                             k1 - p * N1Z) // 2
                            for s in range(3):
                                lo = split_bits(z[0][s], 2)
                                hi = split_bits(z[1][s], 2)
                                for e in range(2):
                                    zp[:, (2 * s + e) * zwords + at] = pack(
                                        lo[e], hi[e])
            for warp in range(warps):                       # stage 2
                for i in range(IPW):
                    item = p * IPP + warp + i * warps
                    mtl = item // (N2 // 16) - p * (N1Z // 16)
                    ng = item % (N2 // 16)
                    u = np.zeros((3, 2, nf, 32, 4), np.float32)
                    for c in range(N2 // 16):
                        at = z_ldmatrix_addresses(N, windowed, mtl, c)
                        a = [regs_of(ldmatrix(zp, at + 2 * e * t["ZPLANE"],
                                              trans=True))
                             for e in range(6)]
                        tile = (c * (N2 // 8) + 2 * ng) * 64
                        w = [b_pair("w2", e * plane_words + tile)
                             for e in range(6)]
                        for j in range(2):
                            bj = [x[:, 2 * j:2 * j + 2] for x in w]
                            for s in range(3):
                                mma(u[s, j], a[2 * s], bj[2 * s])
                                mma(u[s, j], a[2 * s], bj[2 * s + 1])
                                mma(u[s, j], a[2 * s + 1], bj[2 * s])
                    xr = (u[0] - u[1]).astype(np.float32)
                    xi = ((u[2] - u[0]).astype(np.float32)
                          - u[1]).astype(np.float32)
                    power[:, p, i, warp] = np.moveaxis(
                        (xr * xr + xi * xi).astype(np.float32), 1, 0)
        acc = np.zeros(power.shape[1:], np.float32)
        for k in range(nf):                      # in frame order, in f32
            acc = (acc + power[k]).astype(np.float32)
        row = np.full(N, np.nan, np.float32)
        for p in range(ZP):
            for i in range(IPW):
                for warp in range(warps):
                    item = p * IPP + warp + i * warps
                    mt, ng = divmod(item, N2 // 16)
                    for j in range(2):
                        for e in range(4):
                            k1 = 16 * mt + G_ + 8 * (e >> 1)
                            k2 = 16 * ng + 8 * j + 2 * T_ + (e & 1)
                            row[k1 + N1 * k2] = acc[p, i, warp, j, :, e]
        assert not np.isnan(row).any()         # every bin written once
        rows.append(row)
    return np.sum(np.asarray(rows, np.float64), axis=0), group


def test_mma_emulation_is_a_product():
    rng = np.random.default_rng(3)
    A = rng.integers(-8, 8, (16, 16)).astype(np.float32)
    B = rng.integers(-8, 8, (16, 8)).astype(np.float32)
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    for q in range(4):
        r, c = G_ + 8 * (q & 1), 2 * T_ + 8 * (q >> 1)
        a[:, q] = pack(to_bits(A[r, c]), to_bits(A[r, c + 1]))
    for r in range(2):
        b[:, r] = pack(to_bits(B[2 * T_ + 8 * r, G_]),
                       to_bits(B[2 * T_ + 8 * r + 1, G_]))
    d = np.zeros((32, 4), np.float32)
    mma(d, a, b)
    D = A @ B
    for e in range(4):
        np.testing.assert_array_equal(d[:, e],
                                      D[G_ + 8 * (e >> 1), 2 * T_ + (e & 1)])


@pytest.mark.parametrize("N,F,n_valid,window,resident", [
    (256, 64, 50, None, 6), (256, 64, 64, "hann", 4),
    (2048, 48, 40, None, 2), (2048, 48, 37, "blackman", 4),
    (8192, 32, 24, None, 1), (8192, 32, 21, "hann", 1)])
def test_transcription_matches_plain_jax_and_golden(N, F, n_valid, window,
                                                    resident):
    raw = frames(F, N, 3 * N + n_valid)
    w = None if window is None else make_window(window, N)
    got, group = kernel_transcription(raw, n_valid, 8, w, resident)
    assert -(-F // group) <= resident or group == 8
    want = ff.fused_psd_fast_reference(
        torch.from_numpy(raw), n_valid, 8,
        None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=KERNEL_VS_PLAIN_RTOL)
    np.testing.assert_allclose(got, golden(raw, n_valid, w),
                               rtol=RELAXED_RTOL)
    fn = jax_fp.make_fused_psd_fn(N, F, windowed=w is not None, fast=True,
                                  n1=ff.fast_split(N)[0], interpret=True)
    args = (raw.view(np.uint16), n_valid) + (() if w is None else (w,))
    np.testing.assert_allclose(want, np.asarray(fn(*args), np.float64),
                               rtol=PLAIN_VS_JAX_RTOL)


def test_transcription_in_two_z_passes_matches_plain():
    """N = 16384 builds Z in two passes of half the k1 columns; three
    frames masked."""
    N, F = 16384, 16
    raw = frames(F, N, 99)
    got, _ = kernel_transcription(raw, 13, 8, None, 1)
    want = ff.fused_psd_fast_reference(torch.from_numpy(raw), 13, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=KERNEL_VS_PLAIN_RTOL)


# --- the wrapper ---

@pytest.mark.parametrize("raw_offset,ok", [(0, True), (16, True), (4, False),
                                           (8, False)])
def test_alignment_is_the_copies(raw_offset, ok):
    """The frames move by 16-byte cp.async, the window by 4-byte loads."""
    assert (ff.RAW_ALIGN, ff.WINDOW_ALIGN, ff.BULK_ALIGN) == (16, 4, 16)
    raw = torch.zeros(8 * 512 + 16, dtype=torch.uint8)
    raw = raw[raw_offset:raw_offset + 8 * 512].view(8, 512)
    window = torch.ones(257)[1:]
    if ok:
        fp.check_alignment("fused_psd_fast", raw, ff.RAW_ALIGN, window,
                           ff.WINDOW_ALIGN)
    else:
        with pytest.raises(ValueError, match="aligned"):
            fp.check_alignment("fused_psd_fast", raw, ff.RAW_ALIGN, window,
                               ff.WINDOW_ALIGN)


def test_control_on_the_cpu_counts_apart():
    ff.COUNTS.reset()
    ff.CONTROL_COUNTS.reset()
    raw = torch.from_numpy(frames(8, 256, 5))
    got = ff.fused_psd_fast_control(raw, 6, 8)
    want = ff.fused_psd_fast(raw, 6, 8)
    assert torch.equal(got, want)
    assert (ff.CONTROL_COUNTS.kernel, ff.CONTROL_COUNTS.plain) == (0, 1)
    assert (ff.COUNTS.kernel, ff.COUNTS.plain) == (0, 1)


def test_workspace_is_reused_per_key_and_bounded():
    ff._workspaces.clear()
    a = ff._workspace(256, 4, torch.device("cpu"), 0)
    assert ff._workspace(256, 4, torch.device("cpu"), 0) == a
    for rows in range(5, 5 + ff._WORKSPACES):
        ff._workspace(256, rows, torch.device("cpu"), 0)
    assert len(ff._workspaces) == ff._WORKSPACES
    assert (256, 4, None, 0) not in ff._workspaces
    ff._workspaces.clear()


@pytest.mark.cuda
def test_kernel_and_control_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 2048, 64
    raw = torch.from_numpy(frames(F, N, 12)).cuda()
    w = torch.from_numpy(make_window("hann", N)).cuda()
    for window in (None, w):
        got = ff.fused_psd_fast(raw, 50, 64, window)
        ctl = ff.fused_psd_fast_control(raw, 50, 64, window)
        want = ff.fused_psd_fast_reference(raw, 50, 64, window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=KERNEL_VS_PLAIN_RTOL)
        np.testing.assert_allclose(got.cpu().numpy(), ctl.cpu().numpy(),
                                   rtol=KERNEL_VS_PLAIN_RTOL)
        # One frame: the control's products and sums, bit for bit.
        one = raw[:8]
        assert torch.equal(ff.fused_psd_fast(one, 1, 8, window),
                           ff.fused_psd_fast_control(one, 1, 8, window))
