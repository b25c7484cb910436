"""Quickstart on the PyTorch port: the Assise layer + a model.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Twin of ``quickstart.py``: put, fsync, a node kill and failover in a
simulated 3-node cluster, then one loss of a reduced architecture.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import AssiseCluster
from repro_torch.models import Model, RunConfig


def main(argv=None):
    """Returns (the loss, the value read after failover)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as root:
        # 1. A simulated 3-node cluster: this node + a cache replica + a
        #    reserve.
        cluster = AssiseCluster(root, n_nodes=3, replication=2, n_reserve=1,
                                mode="pessimistic")
        try:
            store = cluster.open_process("app0")

            # 2. Operation-granularity writes into colocated "NVM"; fsync
            #    replicates.
            store.put("/hello/world", b"assise")
            store.fsync()
            print("read:", store.get("/hello/world"))

            # 3. Kill the node; fail over to the replica: state is already
            #    there.
            cluster.kill_node(store.sfs.node_id)
            cluster.detect_failures_now()
            store = cluster.failover_process("app0")
            read = store.get("/hello/world")
            print("after failover:", read, "on", store.sfs.node_id)
        finally:
            cluster.close()

    # 4. A reduced assigned architecture, one loss.
    cfg = get_config("gemma3-1b-reduced")
    model = Model(cfg, RunConfig(param_dtype=torch.float32), args.device)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32))).to(model.device)
    loss, _ = model.loss(params, {"tokens": tokens,
                                  "labels": torch.roll(tokens, -1, 1)})
    loss = loss.item()
    print(f"{cfg.name}: loss={loss:.3f}")
    return loss, read


if __name__ == "__main__":
    main()
