"""Library estimators over recorded IQ arrays, on the port's device step.

Ports of ``rtl_power_fftw_tpu/models/{bartlett,welch,scan}.py``: the same
signatures plus an explicit ``device``. Spectrogram and the estimator
family (kurtosis, multitaper, PFB, coherence, cyclostationary) are not
ported yet (ROADMAP.md, Queue 1).
"""

from .bartlett import bartlett_psd  # noqa: F401
from .scan import plan_hop_freqs, scan_psd  # noqa: F401
from .welch import welch_psd  # noqa: F401
