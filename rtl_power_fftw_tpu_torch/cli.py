"""Command-line entry point.

The ``main`` equivalent (rtl_power_fftw.cxx:50-233): parse → aux data →
open device → run session → map exceptions to exit codes. Run as
``python -m rtl_power_fftw_tpu_torch [options]`` or via the
``rtl_power_fftw_tpu_torch`` console script; it needs a CUDA device and
exits 7 without one.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from rtl_power_fftw_tpu.auxdata import AuxData
from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.exceptions import ReturnValue, RPFexception
from rtl_power_fftw_tpu.sources.registry import open_device

from .device import device_runtime_errors, require_cuda
from .session import check_ported, run_session


def main(argv: Optional[List[str]] = None,
         device: Optional[torch.device] = None) -> int:
    """Run one session; returns the exit code. ``device`` is for the
    Python API only: the command line always runs on the first CUDA
    device."""
    if argv is None:
        argv = sys.argv[1:]
    final_retval = ReturnValue.Success
    source = None
    try:
        params = parse_args(argv)
        # Before the device check: an unported option exits 3 on any host.
        check_ported(params)
        if device is None:
            device = require_cuda()
        aux = AuxData(params)
        source = open_device(params)
        final_retval = run_session(params, source, aux, device=device)
    except RPFexception as exception:
        print(str(exception), file=sys.stderr)
        final_retval = exception.return_value
    except device_runtime_errors() as exception:
        print(f"Device runtime error: {exception}", file=sys.stderr)
        final_retval = ReturnValue.HardwareError
    finally:
        if source is not None:
            source.close()
    return int(final_retval)


if __name__ == "__main__":
    sys.exit(main())
