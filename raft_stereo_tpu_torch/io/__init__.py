"""io of the PyTorch port."""
