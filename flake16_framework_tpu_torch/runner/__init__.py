"""Host-side runner pieces (jax- and torch-free)."""
