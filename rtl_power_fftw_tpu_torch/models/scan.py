"""Batched wideband scan over recorded per-hop IQ captures.

Port of ``rtl_power_fftw_tpu/models/scan.py`` (BASELINE.json config 4:
retune hops x bins stitched into one wideband spectrum). The live session
retunes sequentially, like the reference's hop loop
(rtl_power_fftw.cxx:132-174); recorded hop captures have no such
constraint, so every hop's step is enqueued on the device before the
first result is read back.

Stitching follows the reference's contract (doc/rtl_power_fftw.1.md:118):
``stitch="per-hop"`` returns each hop's (freqs, psd) as-is, in hop order;
``"concat"`` one concatenated pair, like parsing the reference's
multi-spectrum output; ``"merge"`` grid-aligns the hops and averages the
overlaps in linear power (``rtl_power_fftw_tpu.utils.stitch``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..planning import Plan

from ..ops.spectral import (PsdStep, bin_frequencies, finalize_psd,
                            pad_frames)


def scan_psd(hop_captures: np.ndarray,
             hop_freqs: Sequence[int],
             N: int, sample_rate: int,
             window: Optional[np.ndarray] = None,
             linear: bool = False,
             baseline: Optional[np.ndarray] = None,
             backend: str = "auto",
             stitch: str = "per-hop", *,
             device):
    """Averaged PSD per hop, every hop's step enqueued on ``device``
    before the first is read back.

    hop_captures: (H, samples·2) u8, one recorded capture per hop (equal
    lengths; the frame count per hop is samples // N).
    hop_freqs: (H,) tuned center frequencies.
    """
    caps = np.asarray(hop_captures, dtype=np.uint8)
    if caps.ndim != 2:
        raise ValueError("hop_captures must be (H, bytes)")
    H = caps.shape[0]
    if H != len(hop_freqs):
        raise ValueError("hop_freqs length must match hop_captures")
    frames_per_hop = caps.shape[1] // (2 * N)
    if frames_per_hop == 0:
        raise ValueError("captures shorter than one FFT frame")

    frames = caps[:, :frames_per_hop * 2 * N].reshape(H * frames_per_hop,
                                                      2 * N)
    hop_step = PsdStep(N, frames_per_hop, device, window=window,
                       backend=backend)
    pending = []
    for h in range(H):
        batch = frames[h * frames_per_hop:(h + 1) * frames_per_hop]
        pending.append(hop_step(pad_frames(batch, hop_step.F),
                                frames_per_hop))
    results: List[np.ndarray] = []
    with np.errstate(divide="ignore"):
        for dev_pwr in pending:
            pwr = dev_pwr.cpu().numpy().astype(np.float64)
            results.append(finalize_psd(pwr, frames_per_hop, sample_rate,
                                        linear=linear, baseline=baseline))

    out = [(bin_frequencies(int(hop_freqs[h]), N, sample_rate), results[h])
           for h in range(H)]
    if stitch == "per-hop":
        return out
    if stitch == "concat":
        return (np.concatenate([f for f, _ in out]),
                np.concatenate([p for _, p in out]))
    if stitch == "merge":
        from ..utils.stitch import merge_spectra
        return merge_spectra(out, db=not linear)
    raise ValueError(f"unknown stitch mode: {stitch}")


def plan_hop_freqs(startfreq: int, stopfreq: int, sample_rate: int,
                   min_overlap: float = 0.0) -> List[int]:
    """The session's exact hop-center arithmetic (planning.Plan) exposed
    for recorded-scan workflows."""
    from ..config import Params
    p = Params()
    p.freq_hopping_isSet = True
    p.startfreq = int(startfreq)
    p.stopfreq = int(stopfreq)
    p.min_overlap = float(min_overlap)
    p.buf_length_isSet = True  # don't touch buffer sizing
    return Plan(p, sample_rate).freqs_to_tune
