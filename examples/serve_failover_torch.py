"""Batched decoding on the PyTorch port with Assise-backed session state:
the serving node is killed mid-generation and the session resumes on the
replica from the last state snapshot (O(1)-state SSM archs make this
near-free).

    PYTHONPATH=src python examples/serve_failover_torch.py  # the card
    PYTHONPATH=src python examples/serve_failover_torch.py --device cpu

Twin of ``serve_failover.py``; arguments after the script's override its
own.
"""
import sys
import tempfile

from repro_torch.launch import serve


def main(argv=None):
    """Returns ``serve.main``'s (tokens, stats)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    with tempfile.TemporaryDirectory() as workdir:
        return serve.main(["--arch", "rwkv6-1.6b-reduced", "--batch", "4",
                           "--prompt-len", "32", "--gen", "48",
                           "--snapshot-every", "16", "--inject-failure", "24",
                           "--workdir", workdir] + argv)


if __name__ == "__main__":
    main()
