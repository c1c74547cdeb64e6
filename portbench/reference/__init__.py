"""Plain float32 references of the port's model families, one module per
family (``<family>.py``).  They import torch and numpy only: nothing of
the port, of the JAX package or of JAX."""
