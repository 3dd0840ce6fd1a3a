"""The benchmark's harness: cell data, weights and traffic from the seed,
the trace reader, the peaks, the work counts and the arithmetic of each
layer kind (`harness.kinds`)."""
