"""Library estimators over recorded IQ arrays, on the port's device steps.

Ports of ``rtl_power_fftw_tpu/models/{bartlett,welch,scan,kurtosis,
multitaper,pfb,spectrogram,coherence,cyclo}.py``: the same signatures plus
an explicit keyword-only ``device``. The spectral-kurtosis, multitaper and
polyphase-filterbank modules also hold the session steps of
``--sk-file``/``--sk-excise``, ``--multitaper`` and ``--pfb-taps``, on one
stream and over ``--streams`` (the ``Sharded*`` steps; each on its own
hand-written kernel and its streams entry). ``spectrogram``,
``coherence``, ``spectral_correlation`` and ``pfb_channelize`` run on the
frames kernel, the cross-spectral kernel, the frames and
spectral-correlation kernels, and the PFB library's channelizer, at the
powers of two from 64 to 16384 bins (channels).
"""

from .bartlett import bartlett_psd  # noqa: F401
from .coherence import coherence  # noqa: F401
from .cyclo import spectral_correlation  # noqa: F401
from .kurtosis import (ShardedSkStep, SkSessionStep,  # noqa: F401
                       compute_sk, spectral_kurtosis)
from .multitaper import (MultitaperSessionStep,  # noqa: F401
                         ShardedMultitaperStep, dpss_tapers, multitaper_psd)
from .pfb import (PfbSessionStep, ShardedPfbStep,  # noqa: F401
                  pfb_channelize, pfb_prototype, pfb_psd)
from .scan import plan_hop_freqs, scan_psd  # noqa: F401
from .spectrogram import spectrogram  # noqa: F401
from .welch import welch_psd  # noqa: F401
