"""Configuration policy of the PyTorch port."""
