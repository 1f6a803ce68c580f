"""Multi-stream acquisition on PyTorch (port of ``rtl_power_fftw_tpu.parallel``
for the one-card ``--streams`` path)."""

from .mesh import make_mesh  # noqa: F401
from .multistream import MultiStreamAcquisition, MultiStreamResult  # noqa: F401
from .sharded import ShardedPsdStep  # noqa: F401
