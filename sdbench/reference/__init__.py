"""Plain references: NumPy and plain PyTorch, importing nothing of the
program and taking nothing that it made."""
