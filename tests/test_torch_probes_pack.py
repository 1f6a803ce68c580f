"""The port's stage-1 relayout and packing probes (P17, P2, P6, P5) on the
CPU.

Each Hopper variant's plain PyTorch version
(``ops/kernels/fused_psd_probe.py``) is held against its TPU probe at
N = 2048, the port's split N1 x N2 = 32 x 64, F = 16 and the TPU's tile 8:

- P17: ``probes/s2_u32t.py`` runs itself, loaded by path with
  ``pl.pallas_call`` forced into interpret mode (its ``pltpu.bitcast``
  runs there). Its ``base`` and ``u32t`` and the plain versions of
  ``tpu6`` and ``tpu6_u32t`` run the same bf16 terms and products and
  differ only in the order of f32 sums: rtol 5e-6, as P16's e2
  (tests/test_torch_probes_s2.py). ``tpu6_u32t``'s plain version equals
  ``tpu6_e2``'s array for array (the same raw bytes, relaid).
- P2, P6 and P5: ``probes/profile_pallas.py`` cannot be imported (it runs
  P1's variants at import, 148, and its ``consts_np``, 23, unpacks
  today's seven ``_constants`` arrays into eight names, 165, 433, 520).
  The three ``build_*`` function nodes are parsed out of the file with
  ``ast`` and executed in a namespace of their own, with the eight
  Karatsuba arrays the text expects as ``consts_np``, and run in
  interpret mode. Their stage 1 is the Karatsuba of 3 products (t1, t2,
  t3) and the port's is K3's K-stacked complex product, which agree to f32
  rounding: rtol 2e-5, P1's (tests/test_torch_probes.py).

The CUDA kernels run only on a card (chip_smoke.py, and the test marked
``cuda``); the packed and wide stage-1 gathers, their B-fragment indices
and Z stores, and P17's pair-word load and byte map are transcribed here
from ``csrc/fused_psd_fast.cuh`` and run on one frame in float64.
"""

import ast
import importlib
import importlib.util
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp

REPO = Path(__file__).resolve().parents[1]
N, N1, N2 = fpp.N, fpp.N1, fpp.N2
PACK, Q = fpp.PACK, fpp.PACK_ROWS
F = 16
TILE = 8
VS_JAX_RTOL = 5e-6
P1_RTOL = 2e-5
BF = ml_dtypes.bfloat16

NEW = ("tpu6_u32t", "k3_pack", "k3_pack_pq", "k3_s1wide")
BUILDS = {"pack8": "build_pack8", "pack8c": "build_pack8c",
          "s1wide": "build_s1wide"}


def frames(F, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def plain(variant, raw8, n_valid=None, chunk=F):
    t = torch.from_numpy(raw8)
    return fpp.fused_psd_probe(variant, t, raw8.shape[0] if n_valid is None
                               else n_valid, chunk).numpy()


def golden(raw8):
    x = ((raw8[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw8[:, 1::2].astype(np.float64) - 127.0))
    return (np.abs(np.fft.fft(x, axis=1)) ** 2).sum(0)


def u16(raw8):
    return raw8.reshape(raw8.shape[0], N, 2).view(np.uint16) \
        .reshape(raw8.shape[0], N)


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call forced into interpret mode; the environment and
    sys.path a TPU probe touches are restored afterwards."""
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    return monkeypatch


# --- P17 against probes/s2_u32t.py ---

@pytest.fixture
def s2_u32t(interpret):
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_s2_u32t", REPO / "probes" / "s2_u32t.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, value in (("N", N), ("F", F), ("N1", N1), ("N2", N2)):
        interpret.setattr(mod, attr, value)
    return mod


@pytest.mark.parametrize("variant", ["base", "u32t"])
def test_p17_plain_against_the_tpu_probe(s2_u32t, variant):
    import jax.numpy as jnp
    raw8 = frames(F, 31)
    want = np.asarray(s2_u32t.build(variant, TILE)(jnp.asarray(u16(raw8)), F))
    got = plain(fpp.PROBES["P17"].variants[variant], raw8)
    assert max_rel(got, want) <= VS_JAX_RTOL
    assert max_rel(got, golden(raw8)) <= 1e-5


@pytest.mark.parametrize("n_valid", [F, 11, 0])
def test_u32t_plain_is_e2s(n_valid):
    raw8 = frames(F, 32)
    np.testing.assert_array_equal(plain("tpu6_u32t", raw8, n_valid, 8),
                                  plain("tpu6_e2", raw8, n_valid, 8))


def test_u32t_offsets_are_s2_u32ts():
    from rtl_power_fftw_tpu.ops.kernels.fused_psd import _constants
    WRp, WIp, *_ = _constants(N, N1, N2, False)
    # s2_u32t.py:53-55 (before the row permutation of 50-52, 57)
    ones = np.full((6 * N1,), 127.0)
    cR = (ones @ WRp.astype(np.float64)).astype(np.float32)
    cI = (ones @ WIp.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fpp.e2_offsets(), np.stack([cR, cI]))
    # the permuted rows (48-52) have the same column sums, to the float64
    # rounding of another summation order
    perm = np.concatenate([np.arange(0, N1, 2), np.arange(1, N1, 2)])
    full = np.concatenate([b * N1 + perm for b in range(6)])
    np.testing.assert_allclose(ones @ WRp[full].astype(np.float64), cR,
                               rtol=0, atol=1e-9)


# --- P2, P6 and P5 against profile_pallas.py's text ---

def _dft(n):
    a = np.arange(n, dtype=np.float64)
    ang = -2.0 * np.pi * (np.outer(a, a) % n) / n
    return np.cos(ang), np.sin(ang)


def _terms(w, k):
    """k bf16 terms of float64 w, as ml_dtypes arrays (rounded through
    float32, as ml_dtypes rounds)."""
    out, r = [], np.asarray(w, np.float64)
    for _ in range(k):
        t = r.astype(np.float32).astype(BF)
        out.append(t)
        r = r - t.astype(np.float64)
    return np.stack(out)


def karatsuba_consts():
    """The eight arrays profile_pallas.py's builds unpack (165, 433, 520):
    w1r, w1i, w1s = split(w1r + w1i) as 3 bf16 terms (3, N1, N1); twr, twi
    (N2, N1) float32; w2r, w2i, w2s as 2 bf16 terms (2, N2, N2)."""
    w1r, w1i = _dft(N1)
    w2r, w2i = _dft(N2)
    _, _, twr, twi, _, _, _ = ff.constants(N, N1, N2, False)
    return (_terms(w1r, 3), _terms(w1i, 3), _terms(w1r + w1i, 3), twr, twi,
            _terms(w2r, 2), _terms(w2i, 2), _terms(w2r + w2i, 2))


@pytest.fixture
def profile_pallas_builds(interpret):
    """build_pack8, build_pack8c and build_s1wide from the text of
    probes/profile_pallas.py, in a namespace of their own."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    path = REPO / "probes" / "profile_pallas.py"
    tree = ast.parse(path.read_text())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name in BUILDS.values()]
    assert sorted(n.name for n in nodes) == sorted(BUILDS.values())
    ns = {"N": N, "F": F, "N1": N1, "N2": N2, "TILE_F": TILE, "np": np,
          "jnp": jnp, "jax": jax, "pl": pl, "pltpu": pltpu,
          "consts_np": karatsuba_consts()}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


@pytest.mark.parametrize("tpu_name", sorted(BUILDS))
@pytest.mark.parametrize("n_valid", [F, 11])
def test_packing_plain_against_the_tpu_text(profile_pallas_builds, tpu_name,
                                            n_valid):
    import jax.numpy as jnp
    raw8 = frames(F, 33)
    fn = profile_pallas_builds[BUILDS[tpu_name]](TILE)
    want = np.asarray(fn(jnp.asarray(u16(raw8)), n_valid))
    probe = "P2" if tpu_name == "pack8" else "P6" if tpu_name == "pack8c" \
        else "P5"
    got = plain(fpp.PROBES[probe].variants[tpu_name], raw8, n_valid)
    assert max_rel(got, want) <= P1_RTOL


def test_s1wide_text_at_twice_the_tile(profile_pallas_builds):
    # profile_pallas.py:508-511 runs s1wide at tiles 128 and 256
    import jax.numpy as jnp
    raw8 = frames(F, 34)
    a = np.asarray(profile_pallas_builds["build_s1wide"](TILE)(
        jnp.asarray(u16(raw8)), F))
    b = np.asarray(profile_pallas_builds["build_s1wide"](2 * TILE)(
        jnp.asarray(u16(raw8)), F))
    assert max_rel(plain("k3_s1wide", raw8), a) <= P1_RTOL
    assert max_rel(plain("k3_s1wide", raw8), b) <= P1_RTOL


@pytest.mark.parametrize("n_valid", [F, 9, 0])
@pytest.mark.parametrize("variant", ["k3_pack", "k3_pack_pq", "k3_s1wide"])
def test_stage1_forms_plain_are_k3s_spectrum(variant, n_valid):
    raw8 = frames(F, 35)
    k3 = plain("k3", raw8, n_valid, 8)
    got = plain(variant, raw8, n_valid, 8)
    if n_valid == 0:
        np.testing.assert_array_equal(got, np.zeros(N, np.float32))
    else:
        assert max_rel(got, k3) <= fpp.RTOL_SCHEME


# --- index transcriptions ---

def test_pack_map_is_n2_p_q_plus_p():
    """(N2, N1) read flat as (Q, PACK·N1): row q, column p·N1 + n1 holds
    n2 = PACK·q + p (profile_pallas.py:182-185); the packed twiddle is the
    same memory (171-174)."""
    x = np.arange(N2 * N1).reshape(N2, N1)
    packed = x.reshape(Q, PACK * N1)
    for q in range(Q):
        for p in range(PACK):
            np.testing.assert_array_equal(packed[q, p * N1:(p + 1) * N1],
                                          x[PACK * q + p])
    _, _, twr, _, _, _, _ = ff.constants(N, N1, N2, False)
    assert np.shares_memory(twr.reshape(Q, PACK * N1), twr)


def test_packed_weights_are_block_diagonal():
    PWR, PWI = fpp.packed_weights()
    WR, WI, *_ = ff.constants(N, N1, N2, False)
    assert PWR.shape == (6 * PACK * N1, PACK * N1)
    for P_, W in ((PWR, WR), (PWI, WI)):
        for b in range(6):
            blk = P_[b * PACK * N1:(b + 1) * PACK * N1]
            want = np.kron(np.eye(PACK, dtype=np.float32),
                           ff.bf16_value(W[b * N1:(b + 1) * N1]))
            np.testing.assert_array_equal(ff.bf16_value(blk), want)
    # 16x K3's stage-1 weight bytes at the port's split
    assert PWR.nbytes + PWI.nbytes == PACK ** 2 * (WR.nbytes + WI.nbytes) \
        == 384 * 1024


def test_pq_permutation_is_pack8cs():
    # profile_pallas.py:530
    perm = np.array([PACK * q + p for p in range(PACK) for q in range(Q)])
    np.testing.assert_array_equal(fpp.pq_permutation(), perm)
    # Z in (p, q) column order times the permuted rows is the same sum
    rng = np.random.default_rng(36)
    z = rng.standard_normal((N1, N2))
    w = rng.standard_normal((N2, N2))
    np.testing.assert_allclose(z[:, perm] @ w[perm], z @ w, rtol=0,
                               atol=1e-12)
    # and P6's slice/concat relayout (560-563) is z[:, perm]
    Y = rng.standard_normal((Q, PACK * N1))   # one frame, lanes (p, k1)
    to2 = np.concatenate([Y[:, p * N1:(p + 1) * N1].T for p in range(PACK)],
                         axis=-1)
    natural = Y.reshape(Q, PACK, N1).transpose(2, 0, 1).reshape(N1, N2)
    np.testing.assert_array_equal(to2, natural[:, perm])


def test_wide_weights_are_s1wides():
    w1r, w1i = _dft(N1)
    r, i = _terms(w1r, 3), _terms(w1i, 3)
    # profile_pallas.py:435-436
    W1cat = np.concatenate([r[0], r[1], r[2], i[0], i[1], i[2]], axis=1)
    np.testing.assert_array_equal(fpp.wide_weights(), W1cat.view(np.uint16))


def byte_perm(x, y, s):
    """__byte_perm(x, y, s) on uint32 arrays, selectors 0..7."""
    b = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
        [(y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for k in range(4):
        out |= b[(s >> (4 * k)) & 7] << (8 * k)
    return out


def pair_words(frame8):
    """fused_psd_fast.cuh's kInPair32 load, transcribed: each thread's two
    uint4 rows 2p, 2p + 1 of 8 samples at n2 = 8c8, interleaved by
    __byte_perm 0x5410 / 0x7632 into words (p, n2); (N1/2, N2) uint32."""
    w = frame8.view(np.uint32)                  # sample pairs, (N/2,)
    out = np.zeros(N // 2, np.uint32)
    for i in range(N // 16):
        p, c8 = i // (N2 // 8), i % (N2 // 8)
        a = w[4 * (2 * p * (N2 // 8) + c8):][:4]
        b = w[4 * ((2 * p + 1) * (N2 // 8) + c8):][:4]
        dst = p * N2 + 8 * c8
        for k in range(4):
            out[dst + 2 * k] = byte_perm(a[k], b[k], 0x5410)
            out[dst + 2 * k + 1] = byte_perm(a[k], b[k], 0x7632)
    return out.reshape(N1 // 2, N2)


def test_pair_word_byte_map():
    """Word (p, n2) holds re(2p), im(2p), re(2p + 1), im(2p + 1) of column
    n2; the u32t gather's byte_perm 0x4240 / 0x4341 give the re and im
    registers of rows (n1, n1 + 1), which _pair_word_planes reads."""
    raw8 = frames(1, 37)[0]
    x = raw8.reshape(N1, N2, 2).astype(np.uint32)     # [n1, n2, re/im]
    words = pair_words(raw8)
    for k, (n1_off, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        np.testing.assert_array_equal((words >> (8 * k)) & 0xFF,
                                      x[n1_off::2, :, c])
    re = byte_perm(words, np.zeros_like(words), 0x4240)
    im = byte_perm(words, np.zeros_like(words), 0x4341)
    np.testing.assert_array_equal(re & 0xFFFF, x[0::2, :, 0])
    np.testing.assert_array_equal(re >> 16, x[1::2, :, 0])
    np.testing.assert_array_equal(im & 0xFFFF, x[0::2, :, 1])
    np.testing.assert_array_equal(im >> 16, x[1::2, :, 1])
    pr, pi = fpp._pair_word_planes(torch.from_numpy(raw8[None].copy()))
    np.testing.assert_array_equal(pr[0].numpy(), x[:, :, 0].T)
    np.testing.assert_array_equal(pi[0].numpy(), x[:, :, 1].T)


def _b_regs(frags, kc, nt):
    """Lane values of B fragment (kc, nt) of pack_b_fragments' output, as
    float64: (32, 4), rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g."""
    return ff.bf16_value(frags[kc, nt]).astype(np.float64)


def _mma(a_regs, b_regs):
    """m16n8k16 from per-lane fragments in float64: a_regs (32, 8) in
    register order, b_regs (32, 4) -> D (16, 8)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            for h in range(2):
                A[g + 8 * (q & 1), 2 * t + 8 * (q >> 1) + h] = \
                    a_regs[lane, 2 * q + h]
        for y in range(2):
            for h in range(2):
                B[2 * t + 8 * y + h, g] = b_regs[lane, 2 * y + h]
    return A @ B


def _reference_z(raw8):
    """Z[n2][k1] of one frame in float64: the length-N1 DFT of each
    column n2 of the dequantized frame, times W_N^(n2·k1)."""
    x = ((raw8[0::2].astype(np.float64) - 127.0)
         + 1j * (raw8[1::2].astype(np.float64) - 127.0)).reshape(N1, N2)
    y = np.fft.fft(x, axis=0).T                       # [n2, k1]
    n2, k1 = np.arange(N2)[:, None], np.arange(N1)[None, :]
    return y * np.exp(-2j * np.pi * n2 * k1 / N)


@pytest.mark.parametrize("pq", [False, True])
def test_packed_stage1_indices_transcribed(pq):
    """fused_psd_fast.cuh:stage1_packed on one frame, products in float64:
    the items, the A gather of x[N2 n1 + PACK q + p], the block-diagonal B
    fragment indices, the twiddle read as (Q, PACK N1) and the Z rows
    (PACK q + p, or p Q + q), against the DFT."""
    raw8 = frames(1, 38)[0]
    iq = u16(raw8[None])[0].astype(np.uint32)
    W = PACK * N1
    frags = [ff.pack_b_fragments(m) for m in fpp.packed_weights()]
    _, _, twr, twi, _, _, _ = ff.constants(N, N1, N2, False)
    tw = (twr + 1j * twi).reshape(-1)
    z = np.full(N, np.nan, complex)
    items = (Q // 16) * (W // 16)
    assert items == N // 256
    for item in range(items):
        mt, ng = item // (W // 16), item % (W // 16)
        yr, yi = np.zeros((2, 16, 8)), np.zeros((2, 16, 8))
        for c in range(W // 16):
            a = np.zeros((2, 32, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    col = 16 * c + 2 * t + 8 * (q >> 1)
                    n = N2 * (col % N1) + PACK * (16 * mt + g + 8 * (q & 1)) \
                        + col // N1
                    for h, v in enumerate((iq[n], iq[n + N2])):
                        a[0, lane, 2 * q + h] = float(v & 0xFF) - 127.0
                        a[1, lane, 2 * q + h] = float(v >> 8) - 127.0
            for b in range(6):
                for j in range(2):
                    kc, nt = b * (W // 16) + c, 2 * ng + j
                    yr[j] += _mma(a[b & 1], _b_regs(frags[0], kc, nt))
                    yi[j] += _mma(a[b & 1], _b_regs(frags[1], kc, nt))
        for j in range(2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    q = 16 * mt + g + 8 * h
                    for e in range(2):
                        col = 16 * ng + 8 * j + 2 * t + e
                        p, k1 = col // N1, col % N1
                        y = yr[j, g + 8 * h, 2 * t + e] \
                            + 1j * yi[j, g + 8 * h, 2 * t + e]
                        row = p * Q + q if pq else PACK * q + p
                        assert np.isnan(z[row * N1 + k1])
                        z[row * N1 + k1] = y * tw[q * W + col]
    want = _reference_z(raw8)
    if pq:
        want = want[fpp.pq_permutation()]
    assert np.abs(z - want.reshape(-1)).max() <= 1e-4 * np.abs(want).max()


def test_wide_stage1_indices_transcribed():
    """fused_psd_fast.cuh:stage1_wide on one frame, products in float64:
    K3's items and gather, the N-stacked B fragment indices of the six
    groups and their combination, against the DFT."""
    raw8 = frames(1, 39)[0]
    iq = u16(raw8[None])[0].astype(np.uint32)
    frags = ff.pack_b_fragments(fpp.wide_weights())
    _, _, twr, twi, _, _, _ = ff.constants(N, N1, N2, False)
    tw = (twr + 1j * twi).reshape(-1)
    z = np.full(N, np.nan, complex)
    for item in range(N // 256):
        mt, ng = item // (N1 // 16), item % (N1 // 16)
        acc = np.zeros((2, 6, 2, 16, 8))
        for c in range(N1 // 16):
            a = np.zeros((2, 32, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g \
                        + 8 * (q & 1)
                    for h, v in enumerate((iq[n], iq[n + N2])):
                        a[0, lane, 2 * q + h] = float(v & 0xFF) - 127.0
                        a[1, lane, 2 * q + h] = float(v >> 8) - 127.0
            for pl_ in range(2):
                for gr in range(6):
                    for j in range(2):
                        acc[pl_, gr, j] += _mma(
                            a[pl_], _b_regs(frags, c, gr * (N1 // 8)
                                            + 2 * ng + j))
        r, i = acc[0], acc[1]
        yr = (r[0] + r[1] + r[2]) - (i[3] + i[4] + i[5])
        yi = (r[3] + r[4] + r[5]) + (i[0] + i[1] + i[2])
        for j in range(2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    for e in range(2):
                        n2 = 16 * mt + g + 8 * h
                        k1 = 16 * ng + 8 * j + 2 * t + e
                        y = yr[j, g + 8 * h, 2 * t + e] \
                            + 1j * yi[j, g + 8 * h, 2 * t + e]
                        assert np.isnan(z[n2 * N1 + k1])
                        z[n2 * N1 + k1] = y * tw[n2 * N1 + k1]
    want = _reference_z(raw8).reshape(-1)
    assert np.abs(z - want).max() <= 1e-4 * np.abs(want).max()


# --- the registry, the work and the wrappers ---

def test_registry_holds_the_packing_probes():
    src = (REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
           "fused_psd_probe.cu").read_text()
    names = list(fpp.VARIANTS)
    for name, code in zip(NEW, (37, 38, 39, 40)):
        v = fpp.VARIANTS[name]
        assert v.code == code and f" = {code}," in src and v.psd
        assert v.kernel == "k3" and v.cut == fpp.CUT_FULL
    # a parity variant is run before the one it is held to
    assert fpp.VARIANTS["tpu6_u32t"].parity == "tpu6_e2"
    assert names.index("tpu6_e2") < names.index("tpu6_u32t")
    assert fpp.VARIANTS["k3_pack"].parity == "K3"
    assert fpp.VARIANTS["k3_pack_pq"].parity == "plain"
    assert fpp.VARIANTS["k3_s1wide"].parity == "plain"
    t = fpp.VARIANTS["tpu6_u32t"]
    assert t.layout == fpp.IN_PAIR32 and t.raw_bytes and t.s2_products == 6
    assert [fpp.VARIANTS[n].s1_form for n in NEW[1:]] == [
        fpp.PACKED, fpp.PACKED_PQ, fpp.WIDE]
    assert all(fpp.VARIANTS[n].s2_products == 3 for n in NEW[1:])


def test_probes_rows():
    assert fpp.PROBES["P17"].module == "s2_u32t"
    assert fpp.PROBES["P17"].source == "probes/s2_u32t.py:154"
    assert fpp.PROBES["P17"].variants == {"base": "tpu6", "u32t": "tpu6_u32t"}
    for tpu, line, name, hopper in (("P2", 227, "pack8", "k3_pack"),
                                    ("P6", 588, "pack8c", "k3_pack_pq"),
                                    ("P5", 492, "s1wide", "k3_s1wide")):
        probe = fpp.PROBES[tpu]
        assert probe.source == f"probes/profile_pallas.py:{line}"
        assert probe.module == "profile_kernel"
        assert probe.variants == {name: hopper}
        # profile_kernel takes the TPU module's own argv name, as P2's,
        # P6's or P5's, not P1's
        assert name not in fpp.PROBES["P1"].variants
        assert fpp.entry_variants("P1", [name, "full"]) == [
            (probe, name), (fpp.PROBES["P1"], "full")]
        assert probe in fpp.entry_probes("P1")
    # with no argv the TPU module runs P1's variants, then pack8 (148, 243)
    assert fpp.PROBES["P1"].then == ("P2",)
    assert fpp.entry_variants("P1")[-1] == (fpp.PROBES["P2"], "pack8")
    with pytest.raises(KeyError):
        fpp.entry_variants("P17", ["pack8"])


def test_work_counts():
    F_ = 4096
    k3 = fpp.k3_work(F_, N)
    s1 = 8 * 3 * N * N1
    # the packed forms compute K3's spectrum: their bound is K3's
    for name in ("k3_pack", "k3_pack_pq"):
        assert fpp.VARIANTS[name].work(F_) == k3
    nbytes, mma, fp32 = fpp.VARIANTS["k3_pack"].work(F_, zero_blocks=True)
    assert mma - k3[1] == F_ * (PACK - 1) * s1        # zero blocks done
    assert nbytes - k3[0] == (PACK ** 2 - 1) * 24 * 1024
    assert fp32 == k3[2]
    assert fpp.VARIANTS["k3_pack_pq"].work(F_, zero_blocks=True) == (
        nbytes, mma, fp32)
    # only the packed forms do more
    assert fpp.VARIANTS["k3_s1wide"].work(F_, zero_blocks=True) == \
        fpp.VARIANTS["k3_s1wide"].work(F_)
    nbytes, mma, fp32 = fpp.VARIANTS["k3_s1wide"].work(F_)
    assert mma == k3[1] and k3[0] - nbytes == 12 * 1024
    assert fp32 == k3[2] + F_ * 8 * N
    assert fpp.VARIANTS["tpu6_u32t"].work(F_) == \
        fpp.VARIANTS["tpu6_e2"].work(F_)


def test_wrappers_dispatch_to_plain_on_cpu_and_count():
    raw = torch.from_numpy(frames(8, 40))
    fpp.COUNTS.reset()
    for name in NEW:
        got = fpp.fused_psd_probe(name, raw, 8, 8, blocks_per_sm=2)
        assert torch.equal(got, fpp.fused_psd_probe_reference(name, raw, 8, 8))
    assert fpp.COUNTS.plain == {name: 1 for name in NEW}
    assert not fpp.COUNTS.kernel


@pytest.mark.cuda
def test_new_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    raw = torch.from_numpy(frames(64, 41)).to(dev)
    ship = {"K3": ff.fused_psd_fast(raw, 40, 16)}
    for name in ("tpu6_e2",) + NEW:
        v = fpp.VARIANTS[name]
        got = fpp.fused_psd_probe(name, raw, 40, 16)
        want = fpp.fused_psd_probe_reference(name, raw, 40, 16)
        assert max_rel(got.cpu(), want.cpu()) <= v.rtol, name
        if v.parity != "plain":
            assert torch.equal(got, ship[v.parity]), name
        ship[name] = got
        assert torch.equal(fpp.fused_psd_probe(name, raw, 40, 16,
                                               blocks_per_sm=1), got), name


# --- the entry points ---

def test_profile_kernel_default_is_p1s_and_pack8(capsys):
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    fpp.COUNTS.reset()
    assert profile_kernel.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if not ln.startswith("#")]
    assert [ln.split()[0] for ln in lines] == \
        list(fpp.PROBES["P1"].default) + ["pack8"]
    assert "[k3_pack]" in lines[-1]
    assert fpp.COUNTS.plain["k3_pack"] == 1
    # P1's lines under P1's header, pack8's under P2's
    heads = [i for i, ln in enumerate(out) if ln.startswith("#")]
    assert heads == [0, len(out) - 2]
    assert out[0].startswith("# P1 (probes/profile_pallas.py:115)")
    assert out[-2].startswith("# P2 (probes/profile_pallas.py:227)")


@pytest.mark.parametrize("argv,names,tiles", [
    (["pack8c", "s1wide", "s1wide:2"], ["pack8c", "s1wide", "s1wide"],
     [1, 1, 2]),
    (["s1wide:4"], ["s1wide"], [4]),
    (["pack8:2", "pack8c"], ["pack8", "pack8c"], [2, 1])])
def test_profile_kernel_takes_the_tpu_modules_names(argv, names, tiles,
                                                    capsys):
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    assert profile_kernel.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if not ln.startswith("#")]
    assert [ln.split()[0] for ln in lines] == names
    # each run of one probe's lines under that probe's header
    tpu = {"pack8": "P2", "pack8c": "P6", "s1wide": "P5"}
    want = [tpu[n] for i, n in enumerate(names) if i == 0 or names[i - 1] != n]
    assert [ln.split()[1] for ln in out if ln.startswith("#")] == want
    assert [int(ln.split("tile=")[1].split()[0]) for ln in lines] == tiles
    assert all("per-step not measured (cpu)" in ln and "max_rel=" in ln
               for ln in lines)


def test_s2_u32t_entry_point_on_cpu(capsys):
    from rtl_power_fftw_tpu_torch.probes import s2_u32t
    fpp.COUNTS.reset()
    assert s2_u32t.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# P17 (probes/s2_u32t.py:154)")
    lines = out[1:]
    assert [ln.split()[0] for ln in lines] == ["base", "u32t"]
    assert "[tpu6]" in lines[0] and "[tpu6_u32t]" in lines[1]
    assert all(float(ln.split("max_rel=")[1].split()[0]) < 1e-5
               for ln in lines)
    assert fpp.COUNTS.plain == {"tpu6": 1, "tpu6_u32t": 1}


@pytest.mark.parametrize("module,argv", [("s2_u32t", ["u32tx"]),
                                         ("s2_u32t", ["tone"]),
                                         ("profile_kernel", ["pack9"])])
def test_entry_points_refuse_an_unknown_variant(module, argv, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{module}")
    assert entry.main(argv + ["--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err


def test_sass_diff_takes_one_earlier_csrc(capsys):
    from rtl_power_fftw_tpu_torch.ops.kernels import sass_diff
    assert sass_diff.main([]) == 2
    assert sass_diff.main(["a", "b"]) == 2
    assert "cuobjdump" in capsys.readouterr().err


@pytest.mark.parametrize("module,argv", [("s2_u32t", []),
                                         ("profile_kernel", ["s1wide"])])
def test_entry_points_need_a_card_unless_told_cpu(module, argv, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{module}")
    assert entry.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
