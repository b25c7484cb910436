"""The loops that drive the port, one a traffic ``kind``: ``serve`` and
``train``. Each ``run(cell, seed, seconds, trace, device, t_start)``
returns (Record, {name: reading}, attempted, failed); the harness
judges the readings against the cell's limits."""
