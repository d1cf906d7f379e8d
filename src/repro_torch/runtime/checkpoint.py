"""Sharded checkpointing through the object store (PyTorch port of
``repro.runtime.checkpoint``) — Starling C1+C2 applied to training state.

Training state is EXTERNALIZED between step-tasks: every leaf of the state
tree is written as a §3.2 partitioned object (row-partitioned into
`n_shards` partitions), so
  * any later mesh can range-read exactly its shard (two GETs per leaf per
    reader) -> elastic re-mesh without resharding jobs;
  * writes use WSM + doublewrite (core/stragglers.py);
  * the manifest PUT is conditional (if-none-match) so duplicated step-tasks
    race safely: FIRST WRITER WINS, losers discard (power of two choices at
    task granularity).

Layout:
  ckpt/<name>/<step>/manifest          json: leaves, dtypes, shapes
  ckpt/<name>/<step>/leaf<i>           partitioned object, n_shards rows-parts

The objects are the reference's byte for byte, so either package restores
the other's checkpoints: leaf i is the i-th leaf in the reference's flatten
order (``models/modules.py:tree_leaves``: dict keys sorted, lists in order,
None dropped), the manifest names dtypes as numpy does ("float32", "int32",
"bfloat16"), and a leaf's bytes are its elements in row-major order. numpy
names bfloat16 only through ``ml_dtypes``, which the port does without: a
bf16 leaf moves as its 16-bit patterns, so ``restore`` returns a full bf16
leaf as a uint16 array of those bits, and ``restore_state`` returns it as a
``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core import format as FMT
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.objectstore.client import ReadReq, StoreClient
from repro_torch.objectstore.store import ObjectStore

_BF16 = "bfloat16"


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16" for torch.bfloat16)."""
    if dtype == torch.bfloat16:
        return _BF16
    return torch.empty(0, dtype=dtype).numpy().dtype.name


def _host_array(leaf: torch.Tensor) -> np.ndarray:
    """The leaf on the host as numpy, by one device-to-host copy; a bf16
    leaf as its bits (uint16)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _leaf_bytes(arr: np.ndarray, n_shards: int) -> bytes:
    arr = np.ascontiguousarray(arr)
    flat = arr.reshape(-1).view(np.uint8)
    cuts = np.linspace(0, flat.size, n_shards + 1).astype(int)
    # one opaque "raw" column per shard-partition: the format moves segment
    # bytes, it does not care that they are not table columns. The parts
    # are views (the reference copies each with tobytes): the same bytes,
    # one pass less over a leaf of up to 515 MB
    parts = [flat[cuts[i]:cuts[i + 1]].data for i in range(n_shards)]
    return FMT.write_partitioned(["raw"], [[p] for p in parts])


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A restored leaf as a tensor that owns a copy of its bytes (the
    store's are read-only)."""
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


class CheckpointManager:
    def __init__(self, store: ObjectStore, name: str,
                 policy: StragglerConfig | None = None, *, n_shards: int = 8,
                 seed: int = 0):
        self.store = store
        self.name = name
        self.policy = policy or StragglerConfig()
        self.n_shards = n_shards
        self.rng = np.random.default_rng(seed)

    def _client(self) -> StoreClient:
        return StoreClient(self.store, self.policy,
                           np.random.default_rng(self.rng.integers(2 ** 63)))

    def _prefix(self, step: int) -> str:
        return f"ckpt/{self.name}/{step}"

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, now: float = 0.0) -> tuple[bool, float]:
        """Save a tree of tensors (on any device; one device-to-host copy a
        leaf). Returns (won_the_race, virtual_end). Leaf writes go out in
        parallel lanes; the manifest write is conditional and LAST, so a
        checkpoint is visible only when complete (atomic commit point)."""
        client = self._client()
        manifest = {"step": step, "n_shards": self.n_shards, "leaves": []}
        end = now
        for i, leaf in enumerate(tree_leaves(state, torch.is_tensor)):
            arr = _host_array(leaf)
            manifest["leaves"].append(
                {"dtype": _dtype_name(leaf.dtype), "shape": list(arr.shape)})
            t = client.write(f"{self._prefix(step)}/leaf{i}",
                             _leaf_bytes(arr, self.n_shards), now)
            end = max(end, t)
        won = self.store.put(f"{self._prefix(step)}/manifest",
                             json.dumps(manifest).encode(),
                             if_none_match=True)
        client.puts += 1
        return won, end + 0.01

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = []
        pref = f"ckpt/{self.name}/"
        for k in self.store.keys():
            if k.startswith(pref) and k.endswith("/manifest"):
                steps.append(int(k[len(pref):].split("/")[0]))
        return max(steps) if steps else None

    def restore(self, step: int, now: float = 0.0, shard: tuple[int, int]
                | None = None):
        """Restore full state as numpy leaves (bf16 as uint16 bits) ->
        (leaves, manifest, end), or shard (i, n) of each leaf's rows as raw
        bytes (uint8) -> (leaves, end).

        Reads use parallel lanes + RSM via the client; each leaf costs two
        range-GETs when reading a shard subset (C2).
        """
        client = self._client()
        manifest = json.loads(
            self.store.get(f"{self._prefix(step)}/manifest"))
        client.gets += 1
        n = manifest["n_shards"]
        leaves = []
        end = now
        for i, meta in enumerate(manifest["leaves"]):
            key = f"{self._prefix(step)}/leaf{i}"
            hdr_req = [ReadReq(key, 0, FMT.header_size(n, 1))]
            (hdr,), t1 = client.read_many(hdr_req, now)
            h = FMT.parse_header(hdr, n, 1, key=key)
            if shard is None:
                first, last = 0, n - 1
            else:
                si, sn = shard
                per = n // sn
                first, last = si * per, (si + 1) * per - 1
            lo, hi = FMT.partition_range(h, first, last)
            (body,), t2 = client.read_many([ReadReq(key, lo, hi)], t1)
            end = max(end, t2)
            arr = np.frombuffer(body, np.uint8)
            if shard is None:
                arr = arr.view(np.uint16 if meta["dtype"] == _BF16
                               else np.dtype(meta["dtype"])).reshape(
                                   meta["shape"])
            leaves.append(arr)
        if shard is not None:
            return leaves, end
        return leaves, manifest, end

    def restore_state(self, template, step: int, now: float = 0.0):
        """Restore into the structure of ``template``, a tree of ParamSpecs
        (``launch/steps.py:train_state_defs``) or of tensors, whose leaves
        must have the stored shapes and dtypes. -> (the tree of CPU
        tensors, virtual end); the caller places them on its device."""
        leaves, manifest, end = self.restore(step, now)
        want = tree_leaves(template)
        if len(want) != len(leaves):
            raise ValueError(f"checkpoint {self._prefix(step)} has "
                             f"{len(leaves)} leaves, the template "
                             f"{len(want)}")
        out = []
        for i, (w, meta) in enumerate(zip(want, manifest["leaves"])):
            if (list(w.shape), _dtype_name(w.dtype)) != (
                    meta["shape"], meta["dtype"]):
                raise ValueError(
                    f"leaf {i} of {self._prefix(step)} is {meta}, the "
                    f"template's {list(w.shape)} {w.dtype}")
            out.append(_tensor(leaves[i], meta["dtype"]))
            leaves[i] = None                 # drop the store's bytes early
        it = iter(out)
        return tree_map(lambda _: next(it), template), end
