"""Synthetic data of the port (copies of the JAX package's numpy code):
conversational worlds (``conversations``), token streams (``lm``), recsys
batches and sessions (``recsys``) and graphs (``graph``)."""
