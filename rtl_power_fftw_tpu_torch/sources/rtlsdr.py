"""Real RTL-SDR hardware via pyrtlsdr (optional; gated import).

This image does not ship pyrtlsdr; the class exists so deployments with the
package installed get real-hardware parity with the reference's direct
librtlsdr path (device.cxx). Import errors surface as NoDeviceFound at the
registry level.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from rtlsdr import RtlSdr  # type: ignore  # pragma: no cover

from .base import IQSource, hardware_error

# The reference sleeps 5 ms after every retune ("inherited from other
# code... hints of strange behaviour if it was commented out",
# device.cxx:117-121). Kept for live-hardware parity.
_POST_TUNE_SETTLE_S = 0.005


class RtlSdrSource(IQSource):  # pragma: no cover - needs hardware
    def __init__(self, dev_index: int = 0):
        try:
            self._sdr = RtlSdr(device_index=dev_index)
        except Exception as e:
            raise hardware_error(f"Could not open rtl_sdr device {dev_index}: {e}")

    def gains(self) -> List[int]:
        return [int(g * 10) for g in self._sdr.valid_gains_db] or [0]

    def sample_rate(self) -> int:
        return int(self._sdr.sample_rate)

    def frequency(self) -> int:
        return int(self._sdr.center_freq)

    def set_frequency(self, frequency: int) -> None:
        try:
            self._sdr.center_freq = frequency
        except Exception:
            raise hardware_error("RTL device: could not set center frequency.")
        # Empirical post-retune settle (device.cxx:117-121).
        time.sleep(_POST_TUNE_SETTLE_S)

    def set_sample_rate(self, sample_rate: int) -> None:
        try:
            self._sdr.sample_rate = sample_rate
        except Exception:
            raise hardware_error("RTL device: could not set sample rate.")

    def set_gain(self, gain: int) -> None:
        try:
            self._sdr.gain = gain / 10.0
        except Exception:
            raise hardware_error("RTL device: could not set gain.")

    def set_freq_correction(self, ppm_error: int) -> None:
        try:
            if ppm_error:
                self._sdr.freq_correction = ppm_error
        except Exception:
            raise hardware_error("RTL device: could not set frequency correction.")

    def _reset_buffer(self) -> None:
        """Flush the USB buffer before each read so a readout never starts
        with stale pre-retune samples (the reference calls
        rtlsdr_reset_buffer at the top of every read, device.cxx:92-97)."""
        try:
            # pyrtlsdr exposes the librtlsdr call on the librtlsdr handle.
            self._sdr.reset_buffer()
        except Exception:
            pass  # older pyrtlsdr: read_bytes resets internally

    def read(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        """Blocking read; success iff the full buffer arrived
        (device.cxx:92-97 returns n_read == buffer.size()).

        pyrtlsdr RAISES (LibUSBError/IOError) where librtlsdr returns a
        short count — map a transient USB error onto the reference's
        dropped-samples retry path instead of crashing the producer."""
        self._reset_buffer()
        try:
            raw = self._sdr.read_bytes(nbytes)
        except Exception as e:  # noqa: BLE001 - library-specific errors
            import sys
            print(f"rtlsdr: read failed ({e}); treating as dropped "
                  "samples.", file=sys.stderr)
            return np.zeros(nbytes, dtype=np.uint8), False
        data = np.frombuffer(raw, dtype=np.uint8)
        return data, len(data) == nbytes

    def close(self) -> None:
        self._sdr.close()
