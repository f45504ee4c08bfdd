"""Transformer-LM serving path of the PyTorch port (decode mode)."""
