"""Device selection for the PyTorch port."""
