"""Device selection, graceful preemption, and the retry budget and fault
sites of the checkpointer, for the PyTorch port."""
