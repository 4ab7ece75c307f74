"""Train a language model with the PyTorch port's fault-tolerant loop:

    PYTHONPATH=src python examples/train_lm_torch.py --arch olmo-1b --steps 100
    PYTHONPATH=src python examples/train_lm_torch.py --arch mixtral-8x7b --steps 50 --device cpu

Runs on the card by default (--device cpu without one); reduced configs
unless --full. Checkpoints to --ckpt-dir and resumes automatically if
re-run. Every family trains."""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    main(sys.argv[1:])
