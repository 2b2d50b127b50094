"""Plain float32 references of what the benchmark's cells run; they import
neither the measured program nor JAX."""
