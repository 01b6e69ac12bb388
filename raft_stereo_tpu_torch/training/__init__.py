"""Training of the PyTorch port: loss, optimizer, state, step, loop."""
