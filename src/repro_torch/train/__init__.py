"""Training substrate on PyTorch: optimizer, step builders, fault-tolerant
loop and checkpointing (one card; the sharded step and elastic remesh wait
for ROADMAP Queue 1's dist/ item)."""
