from . import straggler  # noqa: F401
