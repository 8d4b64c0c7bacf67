"""The benchmark's plain reference: NumPy and plain PyTorch, importing
nothing of the port or of the JAX package."""
