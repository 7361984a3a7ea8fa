"""The scheduler pieces the serving engine needs (copies, no JAX)."""
