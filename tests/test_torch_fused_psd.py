"""The PyTorch package's fused PSD step (K1, and K2 with a window)
against the JAX Pallas kernel.

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

from rtl_power_fftw_tpu.auxdata import make_window
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


@pytest.mark.parametrize("N,F,n_valid,window", [
    (256, 64, 64, "hann"), (512, 64, 37, "blackman"), (1024, 32, 32, "hann"),
    (2048, 16, 16, "flattop")])
def test_windowed_matches_jax_kernel_and_golden(N, F, n_valid, window):
    raw = frames(F, N, 2 * N + n_valid)
    w = make_window(window, N)
    jax_fn = make_fused_psd_fn(N, F, windowed=True, interpret=True)
    want_jax = np.asarray(jax_fn(raw.view(np.uint16), n_valid, w), np.float64)
    got = fp.fused_psd(torch.from_numpy(raw), n_valid, 16,
                       torch.from_numpy(w)).numpy()
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
    np.testing.assert_allclose(got, unshift(gold), rtol=1e-5)
    np.testing.assert_allclose(want_jax, unshift(gold), rtol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=2e-5)


def kernel_transcription(raw: np.ndarray, n_valid: int, chunk: int,
                         window=None):
    """numpy transcription of csrc/fused_psd.cuh, the radix-2 kernel K1
    and K2 were, kept as the probes' control (``fused_psd_probe``'s
    ``k1_full`` and ``radix2_psd``; K1 as it ships is transcribed in
    test_torch_fused_psd_regs.py): word-wise dequantization,
    the window pair of each word (K2: a float2 per 32-bit word, held in
    registers), in-place radix-2 decimation-in-frequency stages with the
    per-stage twiddle table, f32 accumulation per block of
    frames_per_block frames, bit-reversed slot -> bin on the partial-row
    write, and the float64 sum of partial rows."""
    F, N = raw.shape[0], raw.shape[1] // 2
    log2n = N.bit_length() - 1
    tw = fp.stage_twiddles(N)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    group = fp.frames_per_block(F, chunk)
    rev = np.array([int(format(i, f"0{log2n}b")[::-1], 2) for i in range(N)])
    j = np.arange(N // 2)
    if window is not None:
        win = np.asarray(window, np.float32).reshape(N // 2, 2)  # by word
    out = np.zeros(N, np.float64)
    for f0 in range(0, F, group):
        acc = np.zeros(N, np.float32)
        for f in range(f0, min(f0 + group, F, n_valid)):
            w = raw[f].view(np.uint32).astype(np.int64)
            x = np.empty(N, np.complex64)
            x[0::2] = ((w & 0xFF) - 127) + 1j * (((w >> 8) & 0xFF) - 127)
            x[1::2] = (((w >> 16) & 0xFF) - 127) + 1j * ((w >> 24) - 127)
            if window is not None:
                x[0::2] = ((x[0::2].real * win[:, 0])
                           + 1j * (x[0::2].imag * win[:, 0]))
                x[1::2] = ((x[1::2].real * win[:, 1])
                           + 1j * (x[1::2].imag * win[:, 1]))
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


@pytest.mark.parametrize("N,F,n_valid,window", [
    (64, 16, 16, None), (256, 24, 13, None), (2048, 8, 8, None),
    (64, 16, 16, "hann"), (256, 24, 13, "blackman"), (2048, 8, 8, "hann")])
def test_kernel_transcription_matches_golden(N, F, n_valid, window):
    raw = frames(F, N, 3 * N + n_valid)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, 8, w)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
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


@pytest.mark.parametrize("window", [
    torch.ones(128), torch.ones(256, dtype=torch.float64),
    torch.ones((16, 16)), torch.ones(512)[::2], np.ones(256, np.float32),
    torch.ones(256, device="meta")])
def test_rejects_windows_the_kernel_does_not_take(window):
    with pytest.raises(ValueError):
        fp.fused_psd(torch.zeros((8, 512), dtype=torch.uint8), 8, 8, window)


@pytest.mark.parametrize("raw_offset,window_offset,ok", [
    (0, 0, True), (4, 2, True), (1, 0, False), (2, 0, False), (0, 1, False),
    (4, 3, False)])
def test_alignment_check_matches_the_kernels_loads(raw_offset, window_offset,
                                                   ok):
    """The radix-2 control loads the frames as 32-bit words and the window
    as float2: a contiguous view at an offset the loads cannot take must
    raise before a launch (the wrappers run this check on CUDA tensors
    only)."""
    raw = torch.zeros(8 * 512 + 8, dtype=torch.uint8)
    raw = raw[raw_offset:raw_offset + 8 * 512].view(8, 512)
    window = torch.ones(256 + 4)[window_offset:window_offset + 256]
    assert raw.is_contiguous() and window.is_contiguous()
    fp.check_args("fused_psd", fp.fused_psd_eligible, raw, 8, 8, window)
    if ok:
        fp.check_alignment("fused_psd", raw, 4, window, 8)
    else:
        with pytest.raises(ValueError, match="aligned"):
            fp.check_alignment("fused_psd", raw, 4, window, 8)


@pytest.mark.parametrize("raw_offset,window_offset,ok", [
    (0, 0, True), (16, 1, True), (4, 0, False), (8, 1, False),
    (0, 2, True)])
def test_alignment_of_the_register_kernel(raw_offset, window_offset, ok):
    """K1/K2/K4 copy the frames into shared memory 16 bytes a thread and
    read the window as floats: frames 16-byte aligned, the window 4."""
    assert (fp.RAW_ALIGN, fp.WINDOW_ALIGN) == (16, 4)
    raw = torch.zeros(8 * 512 + 16, dtype=torch.uint8)
    raw = raw[raw_offset:raw_offset + 8 * 512].view(8, 512)
    window = torch.ones(256 + 4)[window_offset:window_offset + 256]
    if ok:
        fp.check_alignment("fused_psd", raw, fp.RAW_ALIGN, window,
                           fp.WINDOW_ALIGN)
    else:
        with pytest.raises(ValueError, match="aligned"):
            fp.check_alignment("fused_psd", raw, fp.RAW_ALIGN, window,
                               fp.WINDOW_ALIGN)


def test_cpu_calls_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    fp.fused_psd(torch.zeros((8, 128), dtype=torch.uint8), 8, 8)
    fp.fused_psd(torch.zeros((8, 128), dtype=torch.uint8), 8, 8,
                 torch.ones(64))
    assert (counts.kernel, counts.kernel_windowed, counts.plain) == (0, 0, 2)
    counts.reset()
    assert (counts.kernel, counts.kernel_windowed, counts.plain) == (0, 0, 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (the chip smoke covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 2048, 64
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    w = torch.from_numpy(make_window("hann", N)).cuda()
    before = (fp.COUNTS.kernel, fp.COUNTS.kernel_windowed)
    for window in (None, w):
        got = fp.fused_psd(raw, 50, 64, window)
        want = fp.fused_psd_reference(raw, 50, 64, window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
    assert (fp.COUNTS.kernel, fp.COUNTS.kernel_windowed) == (before[0] + 1,
                                                             before[1] + 1)
