"""AssiseCheckpointer: training state through the CC-NVM layer.

Each worker owns a LibState (colocated persistent cache + chain
replication). A checkpoint is a set of *per-tensor-shard* PUTs — the
operation granularity the paper advocates — followed by a manifest PUT
and an fsync (pessimistic: survives the worker AND its node) or dsync
(optimistic: coalesced; bounded at-risk window). In full mode prefix
semantics make the manifest write the atomic commit point: a restore
only ever sees a fully-written checkpoint.

Delta mode logs only changed blocks vs. the previous step (redundant-
write elimination for sparse-update tensors: embeddings, cold experts).
Each leaf lives at a **stable key** and a step's changes are emitted as
``LibState.write`` byte-range writes straight from the changed-block
bitmap — the ``delta_mask`` kernel's output on the tile-aligned prefix
of each leaf (indices × block → offsets; the CUDA kernel for a
checkpointer on the card, its plain version on the CPU), the host scan
for the unaligned tail. Only the changed ranges
are logged, replicated, and digested; the tradeoff vs per-step blobs is
that in-place deltas make only the *latest* step restorable (older
manifests are kept solely as the commit-point protocol's history), and
a crash mid-save can leave a newer step's partial patches on the stable
keys — manifests carry per-leaf CRCs so ``restore`` detects that and
returns None instead of silently corrupt tensors.

Restore order (the paper's failover story): process-local log ->
node-local hot area -> chain replica NVM -> cold storage — sub-second
for everything above cold.
"""
from __future__ import annotations

import io
import json
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.ckpt.delta import changed_blocks, changed_extents
from repro_torch.core.store import LibState
from repro_torch.kernels.ops import delta_mask
from repro_torch.weights import leaf_to_tensor

_KERNEL_BPT = 8


def _changed_block_idxs(new: bytes, old: bytes, block: int,
                        device: torch.device) -> List[int]:
    """Changed-block bitmap: ``ops.delta_mask`` on the tile-aligned prefix,
    on ``device`` (the on-device scan before the D2H copy of a real
    deployment), the host scan for the unaligned tail. On the card a
    kernel failure raises; there is no fallback to the host scan."""
    tile = block * _KERNEL_BPT
    aligned = (len(new) // tile) * tile
    idxs: List[int] = []
    if aligned:
        # np.save output is immutable bytes: copy into fresh, writable
        # (hence 16-byte aligned) allocations before the upload
        nv = torch.from_numpy(np.frombuffer(new, np.uint8, aligned).copy())
        ov = torch.from_numpy(np.frombuffer(old, np.uint8, aligned).copy())
        mask = delta_mask(nv.to(device), ov.to(device), block=block,
                          bpt=_KERNEL_BPT)
        idxs = torch.nonzero(mask).flatten().tolist()
    first_tail = aligned // block
    tail = changed_blocks(new[aligned:], old[aligned:], block)
    return idxs + [i + first_tail for i in tail]


@dataclass(frozen=True)
class CheckpointConfig:
    prefix: str = "/ckpt/run0"
    mode: str = "pessimistic"  # fsync vs dsync on commit
    delta: bool = True
    delta_block: int = 1 << 16
    keep: int = 2  # checkpoints retained before delete
    async_commit: bool = False  # overlap replication with next step


# A bf16 leaf travels as the raw 2-byte words in a ``V2`` numpy array
# (numpy has no bfloat16). The JAX package writes ``ml_dtypes.bfloat16``
# arrays, whose ``.npy`` header says ``'<V2'`` where numpy writes a plain
# ``V2`` array's as ``'|V2'``; the header is written by hand so that the
# bytes are the JAX package's, header included.
_BF16_DESCR = "<V2"


def _encode_leaf(arr: np.ndarray) -> bytes:
    bio = io.BytesIO()
    if arr.dtype == np.dtype("V2"):
        np.lib.format.write_array_header_1_0(bio, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        bio.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(bio, arr, allow_pickle=False)
    return bio.getvalue()


def _decode_leaf(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        out[prefix] = tree.detach().view(torch.int16).cpu().numpy().view(
            "V2")
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


class AssiseCheckpointer:
    """``device`` is where the delta scan runs: ``"cuda"`` (the default)
    launches the CUDA kernel, ``"cpu"`` its plain version."""

    def __init__(self, store: LibState, cfg: CheckpointConfig =
                 CheckpointConfig(), device="cuda"):
        self.store = store
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self._prev: Dict[str, bytes] = {}  # previous encoded leaves
        self._saved_steps = []
        self._pending: Optional[threading.Thread] = None
        # scan_s: time in the changed-block scan (upload + delta_mask)
        self.stats = {"bytes_full": 0, "bytes_logged": 0, "saves": 0,
                      "scan_s": 0.0}

    def _leaf_key(self, step: int, name: str) -> str:
        if self.cfg.delta:  # stable key: steps patch it in place
            return f"{self.cfg.prefix}/data{name}"
        return f"{self.cfg.prefix}/data/{step}{name}"

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Write one checkpoint. state: pytree of arrays (numpy/torch)."""
        self.wait()  # serialize with any pending async commit
        leaves = _flatten(state)
        manifest = {"step": step, "leaves": sorted(leaves),
                    "extra": extra or {},
                    "format": "range" if self.cfg.delta else "full",
                    "leaf_crc": {}}
        new_prev = {}
        for name, arr in leaves.items():
            raw = _encode_leaf(np.asarray(arr))
            manifest["leaf_crc"][name] = zlib.crc32(raw) & 0xFFFFFFFF
            self.stats["bytes_full"] += len(raw)
            key = self._leaf_key(step, name)
            old = self._prev.get(name) if self.cfg.delta else None
            if old is not None and len(old) == len(raw):
                t_scan = time.monotonic()
                idxs = _changed_block_idxs(raw, old, self.cfg.delta_block,
                                           self.device)
                self.stats["scan_s"] += time.monotonic() - t_scan
                extents = changed_extents(raw, old, self.cfg.delta_block,
                                          idxs=idxs)
                if sum(ln for _, ln in extents) < len(raw):
                    for off, ln in extents:  # range writes: the paper's
                        # op-granularity — only changed bytes hit the log
                        self.store.write(key, raw[off:off + ln], off)
                        self.stats["bytes_logged"] += ln
                else:
                    self.store.put(key, raw)
                    self.stats["bytes_logged"] += len(raw)
            else:
                self.store.put(key, raw)
                self.stats["bytes_logged"] += len(raw)
            new_prev[name] = raw
        # manifest last: the atomic commit point under prefix semantics
        self.store.put(f"{self.cfg.prefix}/MANIFEST.{step}",
                       json.dumps(manifest).encode())
        self.store.put(f"{self.cfg.prefix}/LATEST",
                       str(step).encode())

        def commit():
            if self.cfg.mode == "pessimistic":
                self.store.fsync()
            else:
                self.store.dsync()

        if self.cfg.async_commit:
            self._pending = threading.Thread(target=commit)
            self._pending.start()
        else:
            commit()
        self._prev = new_prev
        self._saved_steps.append(step)
        self.stats["saves"] += 1
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        while len(self._saved_steps) > self.cfg.keep:
            old = self._saved_steps.pop(0)
            man = self.store.get(f"{self.cfg.prefix}/MANIFEST.{old}")
            if man is None:
                continue
            m = json.loads(man)
            if m.get("format") != "range":
                # per-step leaves are private to this checkpoint
                for name in m["leaves"]:
                    self.store.delete(f"{self.cfg.prefix}/data/{old}{name}")
            # range mode: leaves live at stable keys shared by every step
            self.store.delete(f"{self.cfg.prefix}/MANIFEST.{old}")

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        v = self.store.get(f"{self.cfg.prefix}/LATEST")
        return int(v) if v is not None else None

    def restore(self, step: Optional[int] = None):
        """Returns (state_dict {name: np.ndarray}, manifest) or None.

        Range-format checkpoints patch stable keys in place, so only
        the step the manifests agree is latest can be reassembled;
        asking for an older range-format step returns None."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        man = self.store.get(f"{self.cfg.prefix}/MANIFEST.{step}")
        if man is None:
            return None
        m = json.loads(man)
        if m.get("format") == "range" and step != self.latest_step():
            return None  # stable keys already carry later steps' ranges
        out = {}
        crcs = m.get("leaf_crc", {})
        for name in m["leaves"]:
            key = f"{self.cfg.prefix}/data{name}" \
                if m.get("format") == "range" \
                else f"{self.cfg.prefix}/data/{step}{name}"
            raw = self.store.get(key)
            if raw is None:
                return None
            if m.get("format") == "range" and name in crcs \
                    and (zlib.crc32(raw) & 0xFFFFFFFF) != crcs[name]:
                # a crash mid-save left partial range patches of a NEWER
                # step on the stable key: the set is unrestorable — fail
                # loudly rather than hand back silently corrupt tensors
                return None
            out[name] = _decode_leaf(raw)
        return out, m


def unflatten_into(template: Any, flat: Dict[str, np.ndarray],
                   prefix: str = ""):
    """Rebuild a pytree shaped like `template` from restore() output. A
    tensor leaf of the template comes back as a tensor of its dtype on its
    device; any other leaf as the restored numpy array."""
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        t = [unflatten_into(v, flat, f"{prefix}/{i}")
             for i, v in enumerate(template)]
        return type(template)(t) if isinstance(template, tuple) else t
    if isinstance(template, torch.Tensor):
        out = leaf_to_tensor(flat[prefix], template.device)
        if out.dtype != template.dtype or out.shape != template.shape:
            raise ValueError(f"{prefix}: restored {out.dtype} "
                             f"{tuple(out.shape)}, template {template.dtype} "
                             f"{tuple(template.shape)}")
        return out
    return flat[prefix]
