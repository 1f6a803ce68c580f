"""Library estimators over recorded IQ arrays, on the port's device steps.

Ports of ``rtl_power_fftw_tpu/models/{bartlett,welch,scan,kurtosis,
multitaper,pfb}.py``: the same signatures plus an explicit ``device``.
The spectral-kurtosis, multitaper and polyphase-filterbank modules also
hold the session steps of ``--sk-file``/``--sk-excise``, ``--multitaper``
and ``--pfb-taps``, on one stream and over ``--streams`` (the ``Sharded*``
steps; each on its own hand-written kernel and its streams entry).
Spectrogram, coherence, cyclostationary and ``pfb_channelize`` are not
ported yet (ROADMAP.md, Queue 1).
"""

from .bartlett import bartlett_psd  # noqa: F401
from .kurtosis import (ShardedSkStep, SkSessionStep,  # noqa: F401
                       compute_sk, spectral_kurtosis)
from .multitaper import (MultitaperSessionStep,  # noqa: F401
                         ShardedMultitaperStep, dpss_tapers, multitaper_psd)
from .pfb import (PfbSessionStep, ShardedPfbStep,  # noqa: F401
                  pfb_prototype, pfb_psd)
from .scan import plan_hop_freqs, scan_psd  # noqa: F401
from .welch import welch_psd  # noqa: F401
