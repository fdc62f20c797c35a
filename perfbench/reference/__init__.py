"""The plain reference: float32 PyTorch and NumPy, importing nothing of
the program under test."""
