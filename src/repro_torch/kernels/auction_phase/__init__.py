from . import kernel_cuda, ops, ref  # noqa: F401
