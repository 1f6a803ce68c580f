"""IQ source abstraction — the device HAL.

Plays the role of the reference's ``Rtlsdr`` wrapper (device.{h,cxx}) with
the same contract:

* ``read`` returns success only for a complete buffer (device.cxx:92-97 —
  a short read means dropped samples and the data is discarded);
* ``frequency()`` is a *readback*: 0 means the tune did not take
  (acquisition.cxx:236-239);
* setters raise ``RPFexception(HardwareError)`` on failure, which the
  tune-retry loop catches (acquisition.cxx:235-241).

Concrete sources: synthetic signal generator, recorded IQ files, rtl_tcp
network streams, and (if pyrtlsdr is installed) real RTL-SDR hardware.
"""

from __future__ import annotations

import abc
import sys
from typing import List, Tuple

import numpy as np

from ..exceptions import ReturnValue, RPFexception

#: The R820T tuner's gain steps in tenths of dB (librtlsdr's table) —
#: the ONE copy shared by the synthetic and rtl_tcp backends so
#: nearest_gain behaves identically across them.
R820T_GAINS = [0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
               229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
               434, 439, 445, 480, 496]


class IQSource(abc.ABC):
    """Abstract IQ sample source with RTL-SDR-like control surface."""

    @abc.abstractmethod
    def gains(self) -> List[int]:
        """Available gains in tenths of dB (device.cxx:56-70)."""

    @abc.abstractmethod
    def sample_rate(self) -> int:
        """Actual (readback) sample rate in Hz (device.cxx:72-80)."""

    @abc.abstractmethod
    def frequency(self) -> int:
        """Actual (readback) center frequency; 0 = tune failed."""

    @abc.abstractmethod
    def set_frequency(self, frequency: int) -> None: ...

    @abc.abstractmethod
    def set_sample_rate(self, sample_rate: int) -> None: ...

    @abc.abstractmethod
    def set_gain(self, gain: int) -> None: ...

    def set_freq_correction(self, ppm_error: int) -> None:
        """Default: accepted and ignored (only hardware needs it)."""

    @abc.abstractmethod
    def read(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        """Blocking read of exactly ``nbytes`` of interleaved u8 IQ.

        Returns (data, success). success is False when samples were dropped;
        the caller must discard the data and retry (acquisition.cxx:307-316).
        """

    def close(self) -> None:
        """Release resources (RAII dtor equivalent, device.cxx:52-54)."""

    # --- shared helpers (device.cxx:140-163) ---

    def nearest_gain(self, gain: int) -> int:
        """Closest available gain to the requested one (device.cxx:140-151)."""
        best, dif = 0, None
        for trial in self.gains():
            t = abs(trial - gain)
            if dif is None or t < dif:
                dif, best = t, trial
        return best

    def print_gains(self, stderr=None) -> None:
        err = stderr if stderr is not None else sys.stderr
        table = self.gains()
        print("Available gains (in 1/10th of dB): "
              + ", ".join(str(g) for g in table), file=err)


def hardware_error(message: str) -> RPFexception:
    return RPFexception(message, ReturnValue.HardwareError)
