"""Source construction and device-index resolution.

Replaces the reference's librtlsdr device enumeration (device.cxx:30-50)
with a registry: the ``--source`` spec names a backend, and ``-d`` keeps the
reference's index/validation semantics and exit codes.
"""

from __future__ import annotations

from typing import List, Optional

from ..config import Params
from ..exceptions import ReturnValue, RPFexception
from .base import IQSource
from .file import FileSource
from .synthetic import parse_synthetic_spec


def make_source(spec: str, sample_rate: int = 2_048_000,
                seed_offset: int = 0) -> IQSource:
    """Build an IQSource from a CLI spec string.

    Specs: ``synthetic[:opts]`` | ``file:<path>[:loop]`` |
    ``rtl_tcp:<host>[:<port>]`` | ``rtlsdr[:<index>]``.
    ``seed_offset`` shifts a synthetic source's noise seed (used by
    --streams so every extra stream gets independent noise).
    """
    kind, _, rest = spec.partition(":")
    kind = kind.strip().lower()
    if kind == "synthetic":
        try:
            src = parse_synthetic_spec(rest, seed_offset=seed_offset)
        except ValueError as e:
            raise RPFexception(f"Bad --source synthetic spec: {e}",
                               ReturnValue.InvalidArgument)
        # Honor the requested rate like the file source does (the session
        # re-applies params.sample_rate anyway, but library callers of
        # make_source(spec, rate) must not silently get the default).
        src.set_sample_rate(sample_rate)
        return src
    if kind == "file":
        path, _, opt = rest.partition(":")
        if not path:
            raise RPFexception("file source needs a path: file:<path>",
                               ReturnValue.InvalidArgument)
        return FileSource(path, sample_rate=sample_rate, loop=(opt == "loop"))
    if kind == "rtl_tcp":
        host, _, port = rest.partition(":")
        from .rtl_tcp import RtlTcpSource
        try:
            port_no = int(port) if port else 1234
        except ValueError:
            raise RPFexception(f"Bad rtl_tcp port: {port!r}. Exiting.",
                               ReturnValue.InvalidArgument)
        return RtlTcpSource(host or "127.0.0.1", port_no)
    if kind == "rtlsdr":
        try:
            from .rtlsdr import RtlSdrSource  # optional dependency
        except ImportError:
            raise RPFexception(
                "rtlsdr source requires the pyrtlsdr package, which is not "
                "installed.", ReturnValue.NoDeviceFound)
        try:
            index = int(rest) if rest else 0
        except ValueError:
            raise RPFexception(f"Bad rtlsdr device index: {rest!r}. "
                               "Exiting.", ReturnValue.InvalidArgument)
        return RtlSdrSource(index)
    raise RPFexception(f"Unknown --source kind: {kind!r}.",
                       ReturnValue.InvalidArgument)


def make_sources(spec: str, n: int, sample_rate: int = 2_048_000) -> List[IQSource]:
    """Build ``n`` parallel stream sources from one spec (--streams).

    Synthetic streams get distinct seeds (independent noise, same signal
    model); file streams are independent handles on the same recording;
    rtl_tcp streams are separate connections (requires a server per
    stream in practice).
    """
    # Extras are streams 1..n relative to the primary (stream 0), so
    # every synthetic one gets a distinct seed offset. Routing through
    # make_source keeps the parse/error-wrapping AND the
    # set_sample_rate honor in ONE place (library callers must not
    # silently get the default rate).
    return [make_source(spec, sample_rate, seed_offset=i + 1)
            for i in range(n)]


def open_device(params: Params,
                devices: Optional[List[IQSource]] = None) -> IQSource:
    """Resolve ``-d <index>`` against available sources with the reference's
    enumeration semantics (device.cxx:30-50): no devices → exit code 1,
    index out of range → exit code 2."""
    if devices is None:
        devices = []
        if params.source:
            devices.append(make_source(params.source, params.sample_rate))
    if len(devices) == 0:
        raise RPFexception("No RTL-SDR compatible devices found.",
                           ReturnValue.NoDeviceFound)
    if params.dev_index >= len(devices):
        raise RPFexception(
            f"Invalid RTL device number. Only {len(devices)} devices available.",
            ReturnValue.InvalidDeviceIndex)
    return devices[params.dev_index]
