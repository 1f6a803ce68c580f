"""Emulation of C++ iostream default-float formatting.

The reference prints its data with ``std::setprecision(p)`` under the default
floatfield (rtl_power_fftw's text output, acquisition.cxx:412-417, and the
``.met`` sidecar, rtl_power_fftw.cxx:209-218).  C++'s default float formatting
with precision ``p`` is exactly printf's ``%.{p}g``, which Python reproduces
with the ``.{p}g`` format spec (same significant-digit rounding, same
trailing-zero stripping, same ``e±dd`` two-digit exponents).  Byte-for-byte
output parity hinges on this module.
"""

from __future__ import annotations

import math


def cxx_float(value: float, precision: int = 6) -> str:
    """Format ``value`` the way ``std::cout << std::setprecision(p) << value``
    does under the default floatfield.

    Equivalent to C's ``%.{p}g``.  C++ treats ``setprecision(0)`` as
    precision 1 in the default floatfield, as does ``%g`` per the C standard
    ("if the precision is zero, it is taken as 1").
    """
    if precision <= 0:
        precision = 1
    if math.isnan(value):
        # iostreams print "nan"/-nan" like printf
        return "-nan" if math.copysign(1.0, value) < 0 else "nan"
    if math.isinf(value):
        return "inf" if value > 0 else "-inf"
    return f"{value:.{precision}g}"


def cxx_int_trunc(value: float) -> int:
    """C++ double→int conversion: truncation toward zero.

    Used where the reference assigns float expressions to ``int`` metadata
    fields (rtl_power_fftw.cxx:157-160).
    """
    return int(value)
