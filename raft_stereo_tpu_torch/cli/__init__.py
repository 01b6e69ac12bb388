"""cli of the PyTorch port."""
