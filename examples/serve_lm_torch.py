"""Serve batched requests through the PyTorch port's continuous-batching
engine:

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b --requests 8
    PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-large-v3 --device cpu

Runs on the card by default (--device cpu without one); reduced configs
unless --full. Every family serves; the vision and audio archs get stub
patch or frame embeddings."""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:])
