from .base import IQSource  # noqa: F401
from .synthetic import SyntheticSource  # noqa: F401
from .file import FileSource  # noqa: F401
from .registry import make_sources, open_device, make_source  # noqa: F401
