"""Model assets the engine reads (training stays in the JAX package for now)."""
