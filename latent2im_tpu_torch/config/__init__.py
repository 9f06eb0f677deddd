"""CLI flags and attribute vocabularies (own copies of the JAX package's)."""
