"""The plain reference: float32 PyTorch over the reference-format state dict; imports nothing of the program."""
