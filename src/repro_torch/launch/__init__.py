"""Entry points of the PyTorch port run from the command line."""
