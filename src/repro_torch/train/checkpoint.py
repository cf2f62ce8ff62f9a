"""Multi-region checkpointing through the SkyStore virtual object store.

The port of ``repro.train.checkpoint``: the paper's technique as framework
fault tolerance.

  * SAVE: every host serializes its parameter/optimizer shards and PUTs them
    write-local into its pod's region (§2.3) -- no cross-region traffic on the
    hot path.  A small JSON manifest commits the step atomically (it is
    written last; restore only trusts manifested steps).
  * RESTORE: a pod (possibly in a *different* region, after a failure or an
    elastic re-mesh) GETs the shards; SkyStore serves each from the cheapest
    surviving replica and replicates-on-read, so repeated restarts in a new
    region pay egress once.  Old checkpoint replicas age out via the adaptive
    TTL instead of ad-hoc retention scripts.
  * Node failure drill: tests delete a region's physical bytes and restore
    from the surviving replicas (metadata reconcile included).

Arrays are serialized as .npy blobs, one object per (leaf, shard), under the
reference's object keys (``"/".join`` of the leaf's dict keys) and with its
manifests, byte for byte, so either package restores the other's
checkpoints.  A bf16 leaf is written as the reference's ``np.save`` of an
``ml_dtypes.bfloat16`` array writes it (descr ``'<V2'``, the raw 16-bit
words; the manifest says ``"bfloat16"``), and restored from the manifest's
dtype bit for bit.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.virtual_store import VirtualStore
from ..tree import leaves_with_path, unflatten


def _npy(leaf) -> tuple:
    """``(.npy bytes, shape, dtype name)`` of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raw = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        buf = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(raw.shape)})
        buf.write(raw.tobytes())
        return buf.getvalue(), list(raw.shape), "bfloat16"
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue(), list(arr.shape), str(arr.dtype)


def _tensor(data: bytes, dtype: str) -> torch.Tensor:
    arr = np.load(io.BytesIO(data))
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(
        self,
        store: VirtualStore,
        bucket: str,
        region: str,
        name: str = "model",
        keep: int = 3,
    ):
        self.store = store
        self.bucket = bucket
        self.region = region
        self.name = name
        self.keep = keep
        store.create_bucket(bucket)

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree: Any, shard_id: int = 0,
             n_shards: int = 1) -> None:
        """Write-local save of this host's shard of the tree (tensors on any
        device, or numpy arrays)."""
        index = []
        for path, leaf in leaves_with_path(tree):
            key = "/".join(path)
            blob, shape, dtype = _npy(leaf)
            okey = self._okey(step, shard_id, key)
            self.store.put_object(self.bucket, okey, blob, self.region)
            index.append({"key": key, "object": okey,
                          "shape": shape, "dtype": dtype})
        man = {"step": step, "shard": shard_id, "n_shards": n_shards,
               "leaves": index}
        self.store.put_object(
            self.bucket, self._manifest_key(step, shard_id),
            json.dumps(man).encode(), self.region)
        if shard_id == 0:
            self._gc(step)

    # -- restore -----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = set()
        for key in self.store.list_objects(self.bucket,
                                           prefix=f"{self.name}/manifest/"):
            steps.add(int(key.split("/")[-2]))
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, shard_id: int = 0,
                region: Optional[str] = None, like: Any = None) -> Any:
        """Read a shard back as CPU tensors (possibly from another region:
        replicate-on-read pays the cheapest edge once): a dict from leaf
        key to tensor, or, given ``like``, a tree of its structure."""
        region = region or self.region
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint manifest found")
        blob = self.store.get_object(
            self.bucket, self._manifest_key(step, shard_id), region)
        man = json.loads(blob.decode())
        flat: Dict[str, torch.Tensor] = {}
        for ent in man["leaves"]:
            data = self.store.get_object(self.bucket, ent["object"], region)
            flat[ent["key"]] = _tensor(data, ent["dtype"])
        if like is None:
            return flat
        return unflatten(like, [flat["/".join(path)]
                                for path, _ in leaves_with_path(like)])

    # -- retention ---------------------------------------------------------------
    def _gc(self, newest: int) -> None:
        steps = sorted({
            int(k.split("/")[-2])
            for k in self.store.list_objects(self.bucket,
                                             prefix=f"{self.name}/manifest/")
        })
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            for k in self.store.list_objects(
                    self.bucket, prefix=f"{self.name}/step{s:08d}/"):
                self.store.delete_object(self.bucket, k)
            for k in self.store.list_objects(
                    self.bucket, prefix=f"{self.name}/manifest/{s:08d}/"):
                self.store.delete_object(self.bucket, k)

    # -- keys --------------------------------------------------------------------
    def _okey(self, step: int, shard: int, key: str) -> str:
        return f"{self.name}/step{step:08d}/shard{shard:04d}/{key}.npy"

    def _manifest_key(self, step: int, shard: int) -> str:
        return f"{self.name}/manifest/{step:08d}/shard{shard:04d}.json"
