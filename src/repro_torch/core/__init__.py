"""NoMora core in PyTorch: the reference's `repro.core`, module for module.

Ported so far: topology, perf_model, latency, workload (numpy host
modules, copied), policy and auction (torch tensor code on an explicit
device), scheduler_backend, engine, metrics, simulator, and the migration
path: latency_device (the device latency oracle), round_program (the
window program and what-if lanes) and scenarios. Submodules are imported
on use; nothing here imports jax.
"""
