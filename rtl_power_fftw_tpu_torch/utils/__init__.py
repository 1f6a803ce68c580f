from .cxxfmt import cxx_float, cxx_int_trunc  # noqa: F401
from .calibration import (apply_calibration, calibration_offset,  # noqa: F401
                          noise_floor_db, tone_power_db)
