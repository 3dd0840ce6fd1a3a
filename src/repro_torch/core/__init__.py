"""NoMora core in PyTorch: the reference's `repro.core`, module for module.

Every module of `repro.core` has its counterpart here: the numpy host
modules (topology, perf_model, latency, workload, engine, metrics,
metrics_stream, trace, flow_network, scenarios, reference_sim) are copies;
policy, auction and the MCMF Bellman-Ford (mcmf) are torch tensor code on
an explicit device; scheduler_backend, simulator, latency_device (the
device latency oracle), round_program (the window program and what-if
lanes), serving (the online `ScheduleService`) and sweep (grids over a
spawn pool) drive them. Submodules are imported on use; nothing here
imports jax.
"""
