from .text import TextWriter  # noqa: F401
from .matrix import MatrixWriter  # noqa: F401
from .stats import SessionStats  # noqa: F401
