"""Transformer LM of the PyTorch port: decode-mode serving and train-mode
training."""
