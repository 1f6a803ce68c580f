"""Synthetic IQ source: tones + noise at known SNR, u8-quantized.

The fake backend the reference never had (SURVEY §4): plays librtlsdr's
role for tests and benchmarks.  Emitters live at *absolute* RF frequencies;
tuning shifts them into baseband, so frequency-scan stitching can be
validated end-to-end.  Includes injectable faults:

* ``dead_freqs``: tuning near these frequencies fails persistently →
  exercises the TuneError / drop-from-hop-list path
  (rtl_power_fftw.cxx:141-147);
* ``flaky_freqs``: tuning fails on the first N attempts → exercises the
  3-try retry loop (acquisition.cxx:229-249);
* ``drop_every``: every k-th read reports dropped samples → exercises the
  discard-and-retry path (acquisition.cxx:307-316).

Samples are quantized around the +127 convention of datastore.cxx:75 and
generated with phase continuity across reads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .base import IQSource, R820T_GAINS, hardware_error


class SyntheticSource(IQSource):
    DEFAULT_GAINS = R820T_GAINS

    def __init__(self,
                 tones: Sequence[Tuple[float, float]] = (),
                 noise: float = 8.0,
                 seed: int = 0,
                 dc_offset: float = 127.0,
                 dead_freqs: Sequence[int] = (),
                 flaky_freqs: Dict[int, int] | None = None,
                 drop_every: int = 0,
                 dead_tolerance: float = 0.0):
        """tones: [(abs_freq_hz, amplitude_counts)]. noise: std in counts."""
        self.tones = [(float(f), float(a)) for f, a in tones]
        self.noise = float(noise)
        self.rng = np.random.default_rng(seed)
        self.dc_offset = float(dc_offset)
        self.dead_freqs = [int(f) for f in dead_freqs]
        self.flaky_remaining = dict(flaky_freqs or {})
        self.drop_every = int(drop_every)
        self.dead_tolerance = float(dead_tolerance)

        self._rate = 2_048_000
        self._freq = 0
        self._gain = 0
        self._ppm = 0
        self._sample_index = 0  # running time base for phase continuity
        self._read_count = 0

    # --- control surface ---

    def gains(self) -> List[int]:
        return list(self.DEFAULT_GAINS)

    def sample_rate(self) -> int:
        return self._rate

    def frequency(self) -> int:
        return self._freq

    def set_frequency(self, frequency: int) -> None:
        frequency = int(frequency)
        for dead in self.dead_freqs:
            if abs(frequency - dead) <= self.dead_tolerance:
                self._freq = 0
                raise hardware_error("synthetic: could not set center frequency.")
        if frequency in self.flaky_remaining and self.flaky_remaining[frequency] > 0:
            self.flaky_remaining[frequency] -= 1
            self._freq = 0
            raise hardware_error("synthetic: transient tune failure.")
        self._freq = frequency

    def set_sample_rate(self, sample_rate: int) -> None:
        if sample_rate <= 0:
            raise hardware_error("synthetic: could not set sample rate.")
        # Emulate RTL2832U rate quantization? Keep exact: tests reason in
        # exact rates; actual-vs-requested divergence is covered by using
        # odd rates directly.
        self._rate = int(sample_rate)

    def set_gain(self, gain: int) -> None:
        self._gain = int(gain)

    def set_freq_correction(self, ppm_error: int) -> None:
        self._ppm = int(ppm_error)

    # --- data path ---

    def read(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        self._read_count += 1
        n = nbytes // 2
        t = (self._sample_index + np.arange(n)) / self._rate
        self._sample_index += n
        z = np.zeros(n, dtype=np.complex128)
        for f_abs, amp in self.tones:
            # Complex baseband: emitter shifted by the tuned frequency.
            # A real front end band-limits before sampling, so emitters
            # outside the Nyquist band do NOT alias in — without this, a
            # wideband scan would see every tone in every hop (at the
            # aliased frequency), which no hardware does.
            if abs(f_abs - self._freq) > self._rate / 2.0:
                continue
            z += amp * np.exp(2j * np.pi * (f_abs - self._freq) * t)
        # One interleaved draw per sample pair so the generated stream is
        # invariant to read chunking (same bytes regardless of buffer sizes).
        noise = self.rng.normal(0.0, self.noise, (n, 2)) if self.noise > 0 \
            else np.zeros((n, 2))
        re = z.real + noise[:, 0]
        im = z.imag + noise[:, 1]
        buf = np.empty(nbytes, dtype=np.uint8)
        buf[0::2] = np.clip(np.rint(re + self.dc_offset), 0, 255).astype(np.uint8)
        buf[1::2] = np.clip(np.rint(im + self.dc_offset), 0, 255).astype(np.uint8)
        if self.drop_every and self._read_count % self.drop_every == 0:
            return buf, False
        return buf, True


def parse_synthetic_spec(spec: str, seed_offset: int = 0) -> SyntheticSource:
    """Build a SyntheticSource from a CLI spec string.

    Format: ``key=value`` pairs separated by commas.  Keys:
      tone=<freq>[/<amp>]   (repeatable; freq allows k/M/G suffix)
      noise=<std counts>, seed=<int>, dead=<freq> (repeatable),
      drop_every=<k>, offset=<dc counts>
    Example: ``synthetic:tone=1420.40M/30,noise=10,seed=1``
    """
    from ..config import parse_frequency

    tones: List[Tuple[float, float]] = []
    dead: List[int] = []
    kwargs = {}
    if spec:
        for item in spec.split(","):
            if not item:
                continue
            key, _, val = item.partition("=")
            key = key.strip()
            if key == "tone":
                fpart, _, apart = val.partition("/")
                f = parse_frequency(fpart)
                if f < 0:
                    raise ValueError(f"bad tone frequency: {fpart}")
                tones.append((f, float(apart) if apart else 20.0))
            elif key == "dead":
                f = parse_frequency(val)
                if f < 0:
                    raise ValueError(f"bad dead frequency: {val}")
                dead.append(f)
            elif key == "noise":
                kwargs["noise"] = float(val)
            elif key == "seed":
                kwargs["seed"] = int(val)
            elif key == "drop_every":
                kwargs["drop_every"] = int(val)
            elif key == "offset":
                kwargs["dc_offset"] = float(val)
            elif key == "dead_tolerance":
                kwargs["dead_tolerance"] = float(val)
            else:
                raise ValueError(f"unknown synthetic spec key: {key}")
    if seed_offset:
        kwargs["seed"] = kwargs.get("seed", 0) + seed_offset
    return SyntheticSource(tones=tones, dead_freqs=dead, **kwargs)
