"""Training steps (port of `repro.train`): the train step on one device
and FSDP-sharded on a mesh (`steps`), compressed data parallelism
(`compressed_dp`) and the GPipe pipeline over ``pod`` (`pipeline`)."""

from .steps import build_train_step, loss_and_grads  # noqa: F401
