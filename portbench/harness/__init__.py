"""The benchmark's harness: cell data, weights and traffic from the seed,
the trace reader, the peaks and the work counts."""
