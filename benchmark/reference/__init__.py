"""The plain reference that decides `correct`: NumPy and Python integers
over the generated GFA text, importing nothing of panacus_torch or JAX."""
