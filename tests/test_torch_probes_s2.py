"""The port's stage-2 probes (P14, P16, P19, P11) on the CPU.

Each Hopper variant's plain PyTorch version
(``ops/kernels/fused_psd_probe.py``) is held against its TPU probe,
``probes/s2_fourmult.py``, ``s2_left.py``, ``s2_ilv.py`` and
``s2_pipe.py``, loaded by path with ``pl.pallas_call`` forced into
interpret mode, at N = 2048, the port's split N1 x N2 = 32 x 64, F = 16
and the TPU's tile 8:

- on uniform u8 input every TPU variant and the plain version of its
  Hopper variant run the same bf16 terms and products and differ only in
  the order of f32 sums: rtol 5e-6, as the K3 plain version against the
  JAX fast kernel (tests/test_torch_fused_psd_fast.py);
- under the 35 dB tone that P14 and P16 take (``s2_fourmult.py:150-163``)
  a per-bin rtol does not hold for any f32 order (the plain 6-product
  scheme and the TPU's v6 differ by 2.9e-5), so the check is
  class-relative: each plain version's largest error against the
  float64 golden is at most 2x its TPU variant's own on the same frames.
  P19 and P11 take no tone; their schedules' plain version is tpu6's,
  which the tone check holds through ``base``;
- the schedules (ilv, ilv4, pipe) compute tpu6's arithmetic frame by
  frame, so their plain versions are tpu6's array for array; e2's offsets
  and the 4-mult weight stacks are held to numpy transcriptions of the
  TPU probes' lines.

The CUDA kernels run only on a card (chip_smoke.py); the left form's A
fragments and its item and D-fragment index arithmetic, and the
pipelined and chained frame schedules, are transcribed here.
"""

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
from rtl_power_fftw_tpu_torch.probes._timing import tone_frames

REPO = Path(__file__).resolve().parents[1]
N, N1, N2 = fpp.N, fpp.N1, fpp.N2
F = 16
TILE = 8
VS_JAX_RTOL = 5e-6
TONE_FACTOR = 2.0

MODULES = {"P14": "s2_fourmult", "P16": "s2_left", "P19": "s2_ilv",
           "P11": "s2_pipe"}
TPU_VARIANTS = [(tpu, v) for tpu in MODULES
                for v in fpp.PROBES[tpu].variants]
SCHEDULES = ("tpu6_pipe", "tpu6_ilv2", "tpu6_ilv4")
NEW = SCHEDULES + ("tpu6_4mult", "tpu6_e2", "tpu6_left", "tpu6_e2left")


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


@pytest.fixture
def tpu_probe(monkeypatch):
    """Load probes/<name>.py by path, its pallas_call forced into interpret
    mode and its N, F, N1, N2 set to 2048, 16 and the port's split; the
    environment and sys.path it touches are restored afterwards."""
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"tpu_probe_{name}", REPO / "probes" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr, value in (("N", N), ("F", F), ("N1", N1), ("N2", N2)):
            monkeypatch.setattr(mod, attr, value)
        return mod

    return load


def run_tpu(mod, variant, raw8):
    import jax.numpy as jnp
    raw16 = raw8.reshape(F, N, 2).view(np.uint16).reshape(F, N)
    return np.asarray(mod.build(variant, TILE)(jnp.asarray(raw16), F))


# --- against the TPU probes ---

@pytest.mark.parametrize("tpu,variant", TPU_VARIANTS)
def test_plain_against_the_tpu_probe(tpu_probe, tpu, variant):
    raw8 = frames(F, 21)
    want = run_tpu(tpu_probe(MODULES[tpu]), variant, raw8)
    got = plain(fpp.PROBES[tpu].variants[variant], raw8)
    assert max_rel(got, want) <= VS_JAX_RTOL


def test_the_tone_is_the_tpu_probes(tpu_probe):
    raw8, _ = tpu_probe("s2_fourmult").make_input(tone=True)
    np.testing.assert_array_equal(tone_frames(F, N), raw8)


@pytest.mark.parametrize("tpu,variant", [(t, v) for t, v in TPU_VARIANTS
                                         if fpp.PROBES[t].tone])
def test_tone_error_is_class_relative(tpu_probe, tpu, variant):
    raw8 = tone_frames(F, N)
    gold = golden(raw8)
    tpu_err = max_rel(run_tpu(tpu_probe(MODULES[tpu]), variant, raw8), gold)
    ours = max_rel(plain(fpp.PROBES[tpu].variants[variant], raw8), gold)
    assert ours <= TONE_FACTOR * tpu_err, (ours, tpu_err)


@pytest.mark.parametrize("variant", SCHEDULES + ("tpu6_left",))
@pytest.mark.parametrize("n_valid", [F, 11, 0])
def test_schedules_plain_is_tpu6s(variant, n_valid):
    raw8 = frames(F, 22)
    want = plain("tpu6", raw8, n_valid, chunk=8)
    got = plain(variant, raw8, n_valid, chunk=8)
    if variant == "tpu6_left":
        # the same sums contracted from the left: only their f32 order
        assert max_rel(got, want) <= fpp.RTOL_SCHEME
    else:
        np.testing.assert_array_equal(got, want)


def test_e2_offsets_are_s2_lefts():
    from rtl_power_fftw_tpu.ops.kernels.fused_psd import _constants
    WRp, WIp, *_ = _constants(N, N1, N2, False)
    # s2_left.py:56-58, 60-61
    ones = np.full((6 * N1,), 127.0)
    cR = (ones @ WRp.astype(np.float64)).astype(np.float32)
    cI = (ones @ WIp.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fpp.e2_offsets(), np.stack([cR, cI]))


def test_e2_plain_is_the_dequantized_scheme_to_f32_rounding():
    # (raw - 127) W = raw W - 127 colsum(W): the same spectrum.
    raw8 = frames(F, 23)
    assert max_rel(plain("tpu6_e2", raw8), plain("tpu6", raw8)) <= 2e-6


def test_fourmult_weights_are_s2_fourmults():
    from rtl_power_fftw_tpu.ops.kernels.fused_psd import _bf16_terms
    # s2_fourmult.py:46-60
    a = np.arange(N2, dtype=np.float64)
    ang = -2.0 * np.pi * (np.outer(a, a) % N2) / N2
    r3 = [t.astype(np.float64) for t in _bf16_terms(np.cos(ang), 3)]
    i3 = [t.astype(np.float64) for t in _bf16_terms(np.sin(ang), 3)]
    order = (0, 1, 2, 0, 1, 0)
    BF = ml_dtypes.bfloat16
    XR = np.vstack([r3[j] for j in order] + [-i3[j] for j in order]).astype(BF)
    XI = np.vstack([i3[j] for j in order] + [r3[j] for j in order]).astype(BF)
    got_r, got_i = fpp.fourmult_weights()
    np.testing.assert_array_equal(got_r, XR.view(np.uint16))
    np.testing.assert_array_equal(got_i, XI.view(np.uint16))
    # the kernel's 6 B planes are tpu6's first 6: r0..2, i0..2
    _, _, _, _, w2r, w2i, _ = ff.constants(N, N1, N2, False)
    np.testing.assert_array_equal(got_r[:3 * N2], np.vstack(w2r))
    np.testing.assert_array_equal(got_i[6 * N2:9 * N2], np.vstack(w2r))
    np.testing.assert_array_equal(got_i[:3 * N2], np.vstack(w2i))


# --- the left form's fragments and indices, transcribed ---

def test_a_fragment_packing_is_the_mma_layout():
    bits = np.arange(64 * 48, dtype=np.uint16).reshape(64, 48)
    packed = fpp.pack_a_fragments(bits)
    assert packed.shape == (4, 3, 32, 8)
    for mt in range(4):
        for kc in range(3):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    for h in range(2):
                        row = 16 * mt + g + 8 * (q & 1)
                        col = 16 * kc + 2 * t + 8 * (q >> 1) + h
                        assert packed[mt, kc, lane, 2 * q + h] == bits[row, col]


def _mma(a_regs, b_regs):
    """m16n8k16 from per-lane fragments, float64: a_regs (32, 8) bf16
    values in register order, b_regs (32, 4) -> D (16, 8)."""
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


def _bf(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float64)


def _split3(x):
    x = np.asarray(x, np.float32)
    z0 = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    r1 = x - z0
    z1 = r1.astype(ml_dtypes.bfloat16).astype(np.float32)
    z2 = (r1 - z1).astype(ml_dtypes.bfloat16).astype(np.float32)
    return z0, z1, z2


def test_left_stage2_indices_transcribed():
    """fused_psd_fast.cuh:stage2_left on one Z, in float64 products: the
    warps' items, the B gather from Z, the packed A planes and the D
    fragments' bins, against X[k2][k1] = sum W2[n2][k2] Z[n2][k1]."""
    rng = np.random.default_rng(24)
    Z = (rng.standard_normal((N2, N1)) + 1j * rng.standard_normal((N2, N1))
         ).astype(np.complex64)
    _, _, _, _, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    planes = [fpp.pack_a_fragments(np.ascontiguousarray(m[j].T))
              for m in (w2r, w2i, w2s) for j in range(3)]
    planes = [ff.bf16_value(p).astype(np.float64) for p in planes]
    zparts = [_split3(Z.real), _split3(Z.imag),
              _split3(Z.real.astype(np.float32) + Z.imag.astype(np.float32))]
    row = np.full(N, np.nan)
    warps = 8
    items = (N2 // 32) * (N1 // 8)
    for item in range(items):
        assert item % warps == item   # one item a warp at N = 2048
        kh, nt = item // (N1 // 8), item % (N1 // 8)
        u = np.zeros((3, 2, 16, 8))
        for c in range(N2 // 16):
            for part in range(3):
                for term in range(3):
                    b = np.zeros((32, 4))
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        k1 = 8 * nt + g
                        n2 = 16 * c + 2 * t
                        for y, dn in enumerate((0, 8)):
                            for h in range(2):
                                b[lane, 2 * y + h] = \
                                    zparts[part][term][n2 + dn + h, k1]
                    for m in range(2):
                        for wt in range(3):
                            if term + wt >= 3:
                                continue
                            a = planes[3 * part + wt][2 * kh + m, c]
                            u[part, m] += _mma(a, b)
        x = (u[0] - u[1]) + 1j * (u[2] - u[0] - u[1])
        for m in range(2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    k2 = 32 * kh + 16 * m + g + 8 * (e >> 1)
                    k1 = 8 * nt + 2 * t + (e & 1)
                    assert np.isnan(row[k1 + N1 * k2])
                    row[k1 + N1 * k2] = abs(x[m, g + 8 * (e >> 1),
                                              2 * t + (e & 1)]) ** 2
    assert not np.isnan(row).any()
    want = np.abs(np.fft.fft(Z.astype(np.complex128), axis=0)) ** 2  # [k2, k1]
    assert max_rel(row, want.reshape(N)) <= 1e-5


def _pipeline_events(nf):
    """fused_psd_fast.cuh's PIPELINE loop: (iteration, phase, frame,
    buffer) in program order, the prologue's load as iteration -1."""
    ev = [(-1, "store raw", 0, 0)] if nf > 0 else []
    for i in range(nf + 1 if nf > 0 else 0):
        if i < nf:
            ev.append((i, "stage 1", i, i & 1))
        if i > 0:
            ev.append((i, "stage 2", i - 1, (i - 1) & 1))
        if i + 1 < nf:
            ev.append((i, "store raw", i + 1, (i + 1) & 1))
    return ev


@pytest.mark.parametrize("nf", [0, 1, 2, 3, 4, 7])
def test_pipeline_schedule_is_hazard_free_and_in_order(nf):
    ev = _pipeline_events(nf)
    assert [f for _, ph, f, _ in ev if ph == "stage 2"] == list(range(nf))
    assert [f for _, ph, f, _ in ev if ph == "stage 1"] == list(range(nf))
    for it, ph, f, buf in ev:
        if ph == "stage 1":
            # its raw was stored before a barrier, in an earlier iteration
            stored = [e for e in ev if e[1] == "store raw" and e[2] == f]
            assert stored and stored[0][0] < it and stored[0][3] == buf
        if ph == "stage 2":
            # its Z was written one iteration (one barrier) earlier, and
            # no stage 1 of this iteration writes that buffer
            wrote = [e for e in ev if e[1] == "stage 1" and e[2] == f]
            assert wrote[0][0] == it - 1 and wrote[0][3] == buf
            assert all(e[3] != buf for e in ev
                       if e[0] == it and e[1] == "stage 1")
        if ph == "store raw" and it >= 0:
            # the buffer it overwrites is not read in this iteration
            assert all(e[3] != buf for e in ev
                       if e[0] == it and e[1] == "stage 1")


@pytest.mark.parametrize("chains", [2, 4])
@pytest.mark.parametrize("f0,f1", [(0, 8), (0, 7), (4, 5), (0, 0)])
def test_chained_frames_count_once_in_order(chains, f0, f1):
    """The chained loop (CHAINS frames a pass, the first f1 - f of them
    counted) visits each frame of [f0, f1) once, in order."""
    counted = []
    for f in range(f0, f1, chains):
        live = f1 - f
        counted += [f + ch for ch in range(chains) if ch < live]
    assert counted == list(range(f0, f1))


# --- the registry, the work and the wrapper ---

def test_registry_holds_the_stage2_probes():
    for tpu, module in MODULES.items():
        probe = fpp.PROBES[tpu]
        assert probe.module == module
        assert probe.source.startswith(f"probes/{module}.py:")
        assert set(probe.default) == set(probe.variants)
        assert set(probe.variants.values()) <= set(fpp.VARIANTS)
        # the TPU probe's base scheme is tpu6
        assert probe.variants[probe.default[0]] == "tpu6"
    assert fpp.PROBES["P14"].tone and fpp.PROBES["P16"].tone
    assert not fpp.PROBES["P19"].tone and not fpp.PROBES["P11"].tone
    names = list(fpp.VARIANTS)
    src = (REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
           "fused_psd_probe.cu").read_text()
    for name in NEW:
        v = fpp.VARIANTS[name]
        assert names.index(name) > names.index("tpu6")
        assert v.s2_products == 6 and v.psd and f" = {v.code}," in src
        assert v.parity == ("tpu6" if name in SCHEDULES else "plain")
    assert fpp.VARIANTS["tpu6_ilv4"].chains == 4
    assert fpp.VARIANTS["tpu6_pipe"].pipeline


def test_work_counts():
    F_ = 4096
    tpu6 = fpp.VARIANTS["tpu6"].work(F_)
    for name in SCHEDULES + ("tpu6_left",):
        assert fpp.VARIANTS[name].work(F_) == tpu6
    nbytes, mma, fp32 = fpp.VARIANTS["tpu6_4mult"].work(F_)
    s1 = 8 * 3 * N * N1
    # 24 real products of depth N2 a frame against tpu6's 18
    assert mma == F_ * (s1 + 48 * N * N2)
    assert (mma - F_ * s1) / (tpu6[1] - F_ * s1) == 24 / 18
    assert tpu6[0] - nbytes == 3 * N2 * N2 * 2   # 6 weight planes, not 9
    e2 = fpp.VARIANTS["tpu6_e2"].work(F_)
    assert e2[2] == tpu6[2] + F_ * 2 * N and e2[0] == tpu6[0] + 8 * N1
    assert e2[1] == tpu6[1]


def test_chained_variants_take_whole_chains():
    raw = torch.from_numpy(frames(8, 25))
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("tpu6_ilv4", raw, 8, 8, group=6)
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("tpu6_ilv2", raw, 8, 8, group=3)
    assert fpp.block_frames("tpu6_ilv4", 16, 16) == 4
    assert fpp.block_frames("tpu6_ilv2", 4096, 64) == 4
    assert fpp.block_frames("tpu6_ilv4", 4096, 64, 8) == 8
    assert fpp.block_frames("tpu6", 16, 16) == 1
    fpp.COUNTS.reset()
    got = fpp.fused_psd_probe("tpu6_ilv4", raw, 8, 8, group=8)
    assert torch.equal(got, fpp.fused_psd_probe("tpu6", raw, 8, 8))
    assert fpp.COUNTS.plain == {"tpu6_ilv4": 1, "tpu6": 1}
    assert not fpp.COUNTS.kernel


# --- the entry points ---

@pytest.mark.parametrize("tpu", sorted(MODULES))
def test_entry_point_on_cpu(tpu, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{MODULES[tpu]}")
    fpp.COUNTS.reset()
    assert entry.main(["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    probe = fpp.PROBES[tpu]
    assert [ln.split()[0] for ln in lines] == list(probe.default)
    assert all("per-step not measured (cpu)" in ln for ln in lines)
    assert all(f"[{probe.variants[n]}]" in ln
               for n, ln in zip(probe.default, lines))
    assert not fpp.COUNTS.kernel
    assert sum(fpp.COUNTS.plain.values()) == len(probe.default)


@pytest.mark.parametrize("tpu", sorted(MODULES))
def test_entry_point_refuses_an_unknown_variant(tpu, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{MODULES[tpu]}")
    assert entry.main(["bogus", "--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err


@pytest.mark.parametrize("tpu", sorted(MODULES))
def test_entry_point_tone(tpu, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{MODULES[tpu]}")
    rc = entry.main([fpp.PROBES[tpu].default[-1], "tone", "--device",
                     "cpu"])
    out = capsys.readouterr()
    if fpp.PROBES[tpu].tone:
        assert rc == 0 and "35 dB tone" in out.out
        line = [ln for ln in out.out.splitlines()
                if not ln.startswith("#")][0]
        assert float(line.split("max_rel=")[1].split()[0]) < 1e-3
    else:
        assert rc == 2 and "unknown" in out.err


def test_entry_point_refuses_a_tile_of_split_chains(capsys):
    from rtl_power_fftw_tpu_torch.probes import s2_ilv
    assert s2_ilv.main(["ilv4:6", "--device", "cpu"]) == 2
    assert "multiple" in capsys.readouterr().err


@pytest.mark.parametrize("tpu", sorted(MODULES))
def test_entry_point_needs_a_card_unless_told_cpu(tpu, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{MODULES[tpu]}")
    assert entry.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
