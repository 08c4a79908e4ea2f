"""The plain reference that decides a cell's ``correct``: a float32 forward
of the configuration in plain PyTorch, with TF32 off, that works out again
everything the port's plan derives (pruned blocks, int8 payloads and
scales) from the seeded dense weights.  It imports nothing of the port."""
