"""Synthetic conversational worlds (copies of the JAX package's numpy code)."""
