"""Device selection and graceful preemption for the PyTorch port."""
