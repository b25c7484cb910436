"""Count the aten calls the host dispatches, each call that a
``TorchDispatchMode`` sees: a step whose device work is small against the
host's cost a call is paced by the host. Views count too: each is a
dispatch, though none launches a kernel."""
from __future__ import annotations

import collections

from torch.utils._python_dispatch import TorchDispatchMode


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))
