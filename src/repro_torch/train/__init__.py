"""Training steps (port of `repro.train` on one device).

The GPipe pipeline (`repro.train.pipeline`), compressed data parallelism
(`repro.train.compressed_dp`) and the mesh-sharded train and serve steps belong to
the multi-device slices of the port (ROADMAP.md, module queue).
"""

from .steps import build_train_step, loss_and_grads  # noqa: F401
