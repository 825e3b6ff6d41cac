"""The port's benchmark: harness, traffic, yardstick and plain reference."""
