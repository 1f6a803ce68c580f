"""rtl_tcp network IQ source: stream from real RTL-SDR hardware without
librtlsdr, over the standard rtl_tcp wire protocol.

Protocol (rtl_tcp from the rtl-sdr distribution): on connect the server
sends a 12-byte dongle info header (magic "RTL0", tuner type u32, tuner
gain count u32, big-endian), then streams raw interleaved u8 IQ.  Commands
are 5 bytes: u8 opcode + u32 big-endian argument:

  0x01 set center frequency   0x02 set sample rate
  0x03 set gain mode (manual) 0x04 set tuner gain (1/10 dB)
  0x05 set freq correction (ppm)

Dropout contract (mirrors the reference's read-failure semantics,
device.cxx:92-97: a failed ``rtlsdr_read_sync`` is reported, the buffer
discarded, and the producer retries): a lost connection triggers
transparent reconnection with the full device state re-applied (gain
mode, gain, ppm, sample rate, frequency); the interrupted read reports
dropped samples so the session's retry path handles it. Only when
reconnection attempts are exhausted does the source raise HardwareError
(exit 7).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import ReturnValue, RPFexception
from .base import IQSource, R820T_GAINS, hardware_error

_SET_FREQ = 0x01
_SET_SAMPLE_RATE = 0x02
_SET_GAIN_MODE = 0x03
_SET_GAIN = 0x04
_SET_FREQ_CORRECTION = 0x05

# Gain tables per tuner type index in the rtl_tcp header (shared table).
_R820T_GAINS = R820T_GAINS


class RtlTcpSource(IQSource):
    def __init__(self, host: str, port: int = 1234, timeout: float = 10.0,
                 reconnect_tries: int = 3, reconnect_wait: float = 0.5):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._reconnect_tries = reconnect_tries
        self._reconnect_wait = reconnect_wait
        self._sock: Optional[socket.socket] = None
        self._rate = 2_048_000
        self._freq = 0
        self._gain: Optional[int] = None
        self._ppm = 0
        self._pending = bytearray()  # partial data kept across timeouts
        try:
            self._connect()
        except OSError as e:
            raise RPFexception(
                f"Could not connect to rtl_tcp at {host}:{port}: {e}",
                ReturnValue.NoDeviceFound)
        self._send_cmd(_SET_GAIN_MODE, 1)

    # --- connection management ---

    def _connect(self) -> None:
        """(Re)establish the connection and validate the dongle header.
        Raises OSError/RPFexception on failure."""
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._timeout)
        sock.settimeout(self._timeout)
        header = self._recv_exact_on(sock, 12)
        if header[:4] != b"RTL0":
            sock.close()
            raise RPFexception(
                f"Not an rtl_tcp server at {self._host}:{self._port} "
                "(bad magic).", ReturnValue.NoDeviceFound)
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:])
        self._sock = sock

    def _reapply_state(self) -> None:
        """Restore device settings on a fresh connection — the session
        set them once (rtl_power_fftw.cxx:77-101) and expects them live."""
        self._send_cmd(_SET_GAIN_MODE, 1, no_reconnect=True)
        if self._gain is not None:
            self._send_cmd(_SET_GAIN, self._gain, no_reconnect=True)
        if self._ppm:
            self._send_cmd(_SET_FREQ_CORRECTION, self._ppm, no_reconnect=True)
        self._send_cmd(_SET_SAMPLE_RATE, self._rate, no_reconnect=True)
        if self._freq:
            self._send_cmd(_SET_FREQ, self._freq, no_reconnect=True)

    def _reconnect(self) -> bool:
        """Try to re-establish a dropped connection; True on success.

        A fresh rtl_tcp stream restarts at an I/Q pair boundary, so the
        stale partial data is discarded (keeping it would misalign I/Q).
        """
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        for _try in range(self._reconnect_tries):
            time.sleep(self._reconnect_wait)
            try:
                self._connect()
            except (OSError, RPFexception):
                continue
            self._pending.clear()
            try:
                self._reapply_state()
            except RPFexception:
                continue
            import sys
            print(f"rtl_tcp: reconnected to {self._host}:{self._port} "
                  f"(attempt {_try + 1}).", file=sys.stderr)
            return True
        return False

    # --- wire helpers ---

    def _send_cmd(self, opcode: int, arg: int,
                  no_reconnect: bool = False) -> None:
        # A previous failed reconnect leaves _sock = None; later calls
        # (e.g. the session's 3-try tune loop) must get the typed
        # hardware error / a fresh reconnect attempt, not AttributeError.
        if self._sock is not None:
            try:
                self._sock.sendall(
                    struct.pack(">BI", opcode, arg & 0xFFFFFFFF))
                return
            except OSError:
                pass
        if no_reconnect or not self._reconnect():
            raise hardware_error("rtl_tcp: connection lost while sending "
                                 "command.")
        # _reapply_state already ran on the new connection; re-send the
        # command that failed (it may not be part of the cached state yet).
        try:
            self._sock.sendall(struct.pack(">BI", opcode, arg & 0xFFFFFFFF))
        except OSError:
            raise hardware_error("rtl_tcp: connection lost while sending "
                                 "command.")

    @staticmethod
    def _recv_exact_on(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise OSError("connection closed by server")
            buf.extend(chunk)
        return bytes(buf)

    # --- IQSource API ---

    def gains(self) -> List[int]:
        return list(_R820T_GAINS)

    def sample_rate(self) -> int:
        return self._rate  # rtl_tcp has no readback; trust the request

    def frequency(self) -> int:
        return self._freq

    def set_frequency(self, frequency: int) -> None:
        self._send_cmd(_SET_FREQ, int(frequency))
        self._freq = int(frequency)

    def set_sample_rate(self, sample_rate: int) -> None:
        self._send_cmd(_SET_SAMPLE_RATE, int(sample_rate))
        self._rate = int(sample_rate)

    def set_gain(self, gain: int) -> None:
        self._send_cmd(_SET_GAIN, int(gain))
        self._gain = int(gain)

    def set_freq_correction(self, ppm_error: int) -> None:
        if ppm_error != 0:
            self._send_cmd(_SET_FREQ_CORRECTION, int(ppm_error))
            self._ppm = int(ppm_error)

    def read(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        # Partial data from a previous timeout is kept (not discarded):
        # throwing away an odd number of bytes would swap I/Q alignment
        # for the rest of the session. A timed-out read reports dropped
        # samples (like rtlsdr_read_sync, device.cxx:92-97) but the byte
        # stream itself stays contiguous. A CLOSED connection triggers a
        # reconnect (fresh stream, pending discarded) and likewise
        # reports dropped samples so the producer retries.
        try:
            if self._sock is None:  # a previous reconnect failed
                raise OSError("no connection")
            while len(self._pending) < nbytes:
                chunk = self._sock.recv(nbytes - len(self._pending))
                if not chunk:
                    raise OSError("connection closed by server")
                self._pending.extend(chunk)
        except socket.timeout:
            return np.zeros(nbytes, dtype=np.uint8), False
        except OSError:
            if self._reconnect():
                return np.zeros(nbytes, dtype=np.uint8), False
            raise hardware_error("rtl_tcp: connection lost and reconnect "
                                 f"failed after {self._reconnect_tries} "
                                 "attempts.")
        data = bytes(self._pending[:nbytes])
        del self._pending[:nbytes]
        return np.frombuffer(data, dtype=np.uint8), True

    def close(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
