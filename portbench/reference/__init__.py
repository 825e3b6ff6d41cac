"""Plain float32 references of the benchmarked configurations and of NSTI."""
