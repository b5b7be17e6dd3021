"""Graph containers, partitioning, scheduling and the visit engine."""
