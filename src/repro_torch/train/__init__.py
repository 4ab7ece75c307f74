"""Training substrate on PyTorch: optimizer, step builders (one card or a
device mesh), elastic resharding, fault-tolerant loop and checkpointing."""
