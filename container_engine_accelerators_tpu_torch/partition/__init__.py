"""MIG partitions of the node's GPUs (``mig.py``); the partitioner that
programs them is ``cmd/partition_gpu.py``."""
