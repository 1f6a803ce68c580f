"""The PyTorch package's fused PSD step against the JAX Pallas kernel.

On the CPU the wrapper ``fused_psd`` runs the kernel's plain PyTorch
version; the JAX kernel runs in interpret mode, as tests/test_kernels.py
runs it. Both are held to the float64 golden (rtol 1e-5) and to each
other (rtol 2e-5: the two float32 error budgets add). The CUDA kernel's
own index arithmetic is pinned here by a numpy transcription of it; the
kernel itself runs only on a card (chip_smoke.py, and the last test here).
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.kernels import make_fused_psd_fn
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp

from golden import golden_accumulate


def unshift(x):
    return np.fft.ifftshift(np.asarray(x))


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


@pytest.mark.parametrize("N,F,n_valid", [(256, 64, 64), (512, 64, 64),
                                         (2048, 64, 64), (256, 128, 70)])
def test_matches_jax_kernel_and_golden(N, F, n_valid):
    raw = frames(F, N, N + n_valid)
    jax_fn = make_fused_psd_fn(N, F, windowed=False, interpret=True)
    want_jax = np.asarray(jax_fn(raw.view(np.uint16), n_valid), np.float64)
    got = fp.fused_psd(torch.from_numpy(raw), n_valid, 64).numpy()
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
    np.testing.assert_allclose(got, unshift(gold), rtol=1e-5)
    np.testing.assert_allclose(want_jax, unshift(gold), rtol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=2e-5)


def kernel_transcription(raw: np.ndarray, n_valid: int, chunk: int):
    """numpy transcription of csrc/fused_psd.cu: word-wise dequantization,
    in-place radix-2 decimation-in-frequency stages with the per-stage
    twiddle table, f32 accumulation per block of frames_per_block frames,
    bit-reversed slot -> bin on the partial-row write, and the float64
    sum of partial rows."""
    F, N = raw.shape[0], raw.shape[1] // 2
    log2n = N.bit_length() - 1
    tw = fp.stage_twiddles(N)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    group = fp.frames_per_block(F, chunk)
    rev = np.array([int(format(i, f"0{log2n}b")[::-1], 2) for i in range(N)])
    j = np.arange(N // 2)
    out = np.zeros(N, np.float64)
    for f0 in range(0, F, group):
        acc = np.zeros(N, np.float32)
        for f in range(f0, min(f0 + group, F, n_valid)):
            w = raw[f].view(np.uint32).astype(np.int64)
            x = np.empty(N, np.complex64)
            x[0::2] = ((w & 0xFF) - 127) + 1j * (((w >> 8) & 0xFF) - 127)
            x[1::2] = (((w >> 16) & 0xFF) - 127) + 1j * ((w >> 24) - 127)
            for s in range(log2n - 1, -1, -1):
                m = 1 << s
                k = j & (m - 1)
                i0 = ((j >> s) << (s + 1)) + k
                a, b = x[i0], x[i0 + m]
                x[i0] = a + b
                x[i0 + m] = (a - b) * tw[m - 1 + k]
            acc += x.real * x.real + x.imag * x.imag
        row = np.empty(N, np.float32)
        row[rev] = acc
        out += row
    return out


@pytest.mark.parametrize("N,F,n_valid", [(64, 16, 16), (256, 24, 13),
                                         (2048, 8, 8)])
def test_kernel_transcription_matches_golden(N, F, n_valid):
    raw = frames(F, N, 3 * N + n_valid)
    got = kernel_transcription(raw, n_valid, 8)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
    np.testing.assert_allclose(got, unshift(gold), rtol=1e-5)


def test_stage_twiddles_layout():
    N = 16
    tw = fp.stage_twiddles(N)
    assert tw.shape == (N - 1, 2) and tw.dtype == np.float32
    m = 1
    while m < N:
        want = np.exp(-2j * np.pi * np.arange(m) / (2 * m))
        np.testing.assert_array_equal(tw[m - 1:2 * m - 1, 0],
                                      want.real.astype(np.float32))
        np.testing.assert_array_equal(tw[m - 1:2 * m - 1, 1],
                                      want.imag.astype(np.float32))
        m *= 2


@pytest.mark.parametrize("F,chunk,group", [
    (4096, 64, 4),     # timed shape: 1024 blocks
    (400, 16, 1),      # canonical 2048-bin drive
    (3200, 64, 2),     # 256-bin scan drive
    (65536, 64, 64),   # enough frames: a block sums a whole chunk
])
def test_frames_per_block(F, chunk, group):
    assert fp.frames_per_block(F, chunk) == group


@pytest.mark.parametrize("N,ok", [(64, True), (256, True), (2048, True),
                                  (16384, True), (32, False), (32768, False),
                                  (500, False), (0, False)])
def test_eligibility(N, ok):
    assert fp.fused_psd_eligible(N) is ok


@pytest.mark.parametrize("make,n_valid,chunk,exc", [
    (lambda: torch.zeros((8, 512), dtype=torch.int16), 8, 8, TypeError),
    (lambda: torch.zeros(512, dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 513), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 1000), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 65536), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((512, 8), dtype=torch.uint8).t(), 8, 8, ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8), 8, 3, ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8), 9, 8, ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8), -1, 8, ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8, device="meta"), 8, 8,
     ValueError),
])
def test_rejects_what_the_kernel_does_not_take(make, n_valid, chunk, exc):
    with pytest.raises(exc):
        fp.fused_psd(make(), n_valid, chunk)


def test_cpu_calls_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    fp.fused_psd(torch.zeros((8, 128), dtype=torch.uint8), 8, 8)
    assert (counts.kernel, counts.plain) == (0, 1)
    counts.reset()
    assert (counts.kernel, counts.plain) == (0, 0)


def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (the chip smoke covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    N, F = 2048, 64
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    before = fp.COUNTS.kernel
    got = fp.fused_psd(raw, 50, 64)
    want = fp.fused_psd_reference(raw, 50, 64)
    torch.cuda.synchronize()
    assert fp.COUNTS.kernel == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
