"""Library estimators over recorded IQ arrays, on the port's device steps.

Ports of ``rtl_power_fftw_tpu/models/{bartlett,welch,scan,kurtosis,
multitaper,pfb}.py``: the same signatures plus an explicit ``device``.
The spectral-kurtosis, multitaper and polyphase-filterbank modules also
hold the session steps of ``--sk-file``/``--sk-excise``, ``--multitaper``
and ``--pfb-taps`` (one stream; each on its own hand-written kernel).
Spectrogram, coherence, cyclostationary, ``pfb_channelize`` and the
estimators' ``--streams`` steps are not ported yet (ROADMAP.md, Queue 1).
"""

from .bartlett import bartlett_psd  # noqa: F401
from .kurtosis import SkSessionStep, compute_sk, spectral_kurtosis  # noqa: F401
from .multitaper import (MultitaperSessionStep, dpss_tapers,  # noqa: F401
                         multitaper_psd)
from .pfb import PfbSessionStep, pfb_prototype, pfb_psd  # noqa: F401
from .scan import plan_hop_freqs, scan_psd  # noqa: F401
from .welch import welch_psd  # noqa: F401
