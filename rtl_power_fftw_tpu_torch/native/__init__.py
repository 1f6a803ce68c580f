from .binding import NativeLoader, native_available  # noqa: F401
