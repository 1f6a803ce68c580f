"""Multi-stream acquisition on PyTorch (port of ``rtl_power_fftw_tpu.parallel``
for the one-card ``--streams`` path; the estimators' streams steps are in
``models``, picked by :func:`make_streams_step`)."""

from .longint import sharded_accumulate  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .multistream import (MultiStreamAcquisition,  # noqa: F401
                          MultiStreamResult, make_streams_step)
from .sharded import ShardedPsdStep  # noqa: F401
