"""End-to-end training on the PyTorch port with checkpointing + mid-run
node failure and bit-exact resume from the cache replica (paper Fig 7, as
training).

    PYTHONPATH=src python examples/train_failover_torch.py  # the card
    PYTHONPATH=src python examples/train_failover_torch.py --device cpu

Twin of ``train_failover.py``; arguments after the script's override its
own. On the card the deterministic train step needs
``CUBLAS_WORKSPACE_CONFIG`` before the process's first cuBLAS call: run as
a script, this sets it; a caller of ``main`` sets it itself.
"""
import os
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None):
    """Returns ``train.main``'s (losses, stats)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    with tempfile.TemporaryDirectory() as workdir:
        return train.main(["--arch", "gemma3-1b-reduced", "--steps", "14",
                           "--ckpt-every", "4", "--inject-failure", "10",
                           "--workdir", workdir] + argv)


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
