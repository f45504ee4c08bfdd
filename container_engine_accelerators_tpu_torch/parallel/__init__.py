"""Attention across the sequence for the PyTorch port: so far only the
single-device dense attention of train mode (``seq.py``)."""
