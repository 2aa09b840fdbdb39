"""The plain reference the program is judged against: the batches, the
model and its training steps, in float32 PyTorch."""
