"""Entry points of the PyTorch port (run with python -m)."""
