"""Models of the PyTorch port: the transformer LM (decode-mode serving and
train-mode training) and the image models (ResNet, Inception-v3)."""
