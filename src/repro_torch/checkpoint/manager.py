"""CheckpointManager: async, sharded, policy-protected training checkpoints.

Maps a training state (params + optimizer state: nested ``dict``/``list``/
``tuple`` of tensors, numpy arrays or Python scalars) onto the DFS storage
cluster: every leaf is serialized, split into stripe objects, and written
under a resiliency policy — RS(k, m) erasure coding (storage-efficient,
survives m node losses) or k-way replication (ring/PBT).  Writes run on a
background thread (async checkpointing overlaps the next train steps);
``restore`` reads back with degraded-mode reconstruction and verifies
integrity with the capability MAC of each manifest entry.

For the same tree and key the shard layout, object ids, manifest and MACs
are byte-identical to ``repro.checkpoint.manager``'s: leaves are visited
in sorted dict-key order (as ``jax.tree_util`` does), paths join dict keys
and list/tuple indices with ``/``, and ``meta["dtype"]`` is numpy's name
of the dtype (``"float32"``, ``"bfloat16"``, ...).  The erasure code runs
on the cluster's ``device``; ``restore`` returns CPU tensors.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.storage import StorageCluster
from repro_torch.core.auth import sponge_mac
from repro_torch.core.packets import ReplStrategy, Resiliency
from repro_torch.policy.functional import write_plan
from repro_torch.policy.spec import PolicySpec, RS, SpongeAuth, Tree
from repro_torch.trace.host import span

#: bytes of a leaf that its manifest MAC covers
MAC_BYTES = 64


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    resiliency: Resiliency = Resiliency.ERASURE_CODING
    k: int = 4
    m: int = 2
    strategy: ReplStrategy = ReplStrategy.RING
    stripe_bytes: int = 1 << 20       # split big leaves into stripe objects
    #: EC encode locus: "client" batches every stripe of a leaf through one
    #: RSCode.encode_stripes call and writes the shards as authenticated
    #: plain writes; "nic" streams per-packet intermediate parities through
    #: the policy engine (paper section VI).
    encode: str = "client"

    def spec(self) -> PolicySpec:
        """The equivalent declarative policy (``from_spec`` round-trips)."""
        if self.resiliency == Resiliency.ERASURE_CODING:
            engine = "client" if self.encode == "client" else "spin"
            return PolicySpec(
                "spin", SpongeAuth(), erasure=RS(self.k, self.m, engine),
                name="checkpoint-ec",
            )
        if self.resiliency == Resiliency.REPLICATION:
            return PolicySpec(
                "spin", SpongeAuth(), replication=Tree(self.k, self.strategy),
                name="checkpoint-repl",
            )
        return PolicySpec("spin", SpongeAuth(), name="checkpoint-plain")

    @classmethod
    def from_spec(
        cls, spec: PolicySpec, stripe_bytes: int = 1 << 20
    ) -> "CheckpointPolicy":
        plan = write_plan(spec)
        if plan.kind == "flat":
            # Flat has no object layout; silently storing one copy would
            # drop the requested redundancy.
            raise ValueError(
                "Flat replication has no checkpoint layout; use a Tree spec"
            )
        if plan.resiliency == Resiliency.ERASURE_CODING:
            return cls(
                Resiliency.ERASURE_CODING, plan.k, plan.m,
                stripe_bytes=stripe_bytes,
                encode="client" if plan.kind == "ec-client" else "nic",
            )
        if plan.resiliency == Resiliency.REPLICATION:
            return cls(
                Resiliency.REPLICATION, plan.k, 0, plan.strategy,
                stripe_bytes=stripe_bytes,
            )
        return cls(Resiliency.NONE, 1, 0, stripe_bytes=stripe_bytes)


# -- trees --------------------------------------------------------------------


def flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested ``dict``/``list``/``tuple``, dict keys
    in sorted order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in flatten(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree) for item in flatten(sub, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def unflatten(template: Any, leaves: dict[str, Any], prefix: tuple = ()) -> Any:
    """``template``'s structure with each leaf taken from ``leaves`` by path."""
    if isinstance(template, dict):
        return {key: unflatten(sub, leaves, prefix + (key,)) for key, sub in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(sub, leaves, prefix + (i,))
                              for i, sub in enumerate(template))
    if template is None:
        return None
    return leaves[path_str(prefix)]


def path_str(path: tuple) -> str:
    return "/".join(str(part) for part in path)


# -- leaves ---------------------------------------------------------------------


def _snapshot(leaf: Any) -> torch.Tensor | np.ndarray:
    """A private host copy of ``leaf``: training may mutate the original in
    place while the background write is still reading the copy."""
    with span("ckpt.snapshot") as s:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            t = t.cpu() if t.device.type != "cpu" else t.clone()
            out = t.contiguous()
        else:
            out = np.array(leaf, copy=True, order="C")
        if s:
            s.set(bytes=_nbytes(out))
        return out


def _nbytes(x: torch.Tensor | np.ndarray) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _leaf_to_bytes(x: torch.Tensor | np.ndarray) -> tuple[np.ndarray, dict]:
    """The leaf's bytes in C order (a uint8 view of the snapshot) and its
    meta, with the dtype under numpy's name."""
    if isinstance(x, torch.Tensor):
        raw = x.reshape(-1).view(torch.uint8).numpy()
        dtype = str(x.dtype).removeprefix("torch.")
    else:
        raw = x.reshape(-1).view(np.uint8)
        dtype = str(x.dtype)
    return raw, {"dtype": dtype, "shape": list(x.shape)}


def _bytes_to_leaf(raw: np.ndarray, meta: dict) -> torch.Tensor:
    dtype = getattr(torch, meta["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"no torch dtype for checkpoint dtype {meta['dtype']!r}")
    return torch.from_numpy(raw).view(dtype).reshape(meta["shape"])


def _mac(raw: np.ndarray, key: np.ndarray) -> list[int]:
    """The MAC of a leaf's first ``MAC_BYTES`` bytes, zero-padded."""
    head = np.zeros(MAC_BYTES, np.uint8)
    n = min(raw.size, MAC_BYTES)
    head[:n] = raw[:n]
    mac = sponge_mac(head.view(np.uint32), key)
    return [int(mac[0]), int(mac[1])]


class CheckpointManager:
    def __init__(
        self,
        cluster: StorageCluster,
        policy: CheckpointPolicy | PolicySpec | None = None,
    ):
        self.cluster = cluster
        if isinstance(policy, PolicySpec):
            policy = CheckpointPolicy.from_spec(policy)
        self.policy = policy or CheckpointPolicy()
        self._manifests: dict[int, dict] = {}
        self._pending: threading.Thread | None = None
        self._error: Exception | None = None
        self._lock = threading.Lock()
        self.save_seconds: list[float] = []

    # -- save -------------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot on the caller thread, write on a background thread.  A
        failed write raises from the next ``wait`` (``blocking`` waits)."""
        with span("ckpt.save", rid=step) as s:
            snap = [(path_str(p), _snapshot(leaf)) for p, leaf in flatten(tree)]
            if s:
                s.set(leaves=len(snap), bytes=sum(_nbytes(x) for _, x in snap))
            self.wait()
            parent = s.sid

            def worker():
                try:
                    with span("ckpt.write", rid=step, parent=parent, leaves=len(snap)):
                        self._write(step, snap)
                except Exception as exc:   # raised again by wait()
                    self._error = exc

            self._pending = threading.Thread(target=worker, daemon=True)
            self._pending.start()
            if blocking:
                self.wait()

    def _write(self, step: int, snap: list[tuple[str, Any]]) -> None:
        t0 = time.time()
        pol = self.policy
        bulk_ec = (pol.resiliency == Resiliency.ERASURE_CODING
                   and pol.encode == "client")
        manifest = {"step": step, "leaves": [], "policy": {
            "resiliency": int(pol.resiliency),
            "k": pol.k, "m": pol.m, "encode": pol.encode,
        }}
        for path, arr in snap:
            raw, meta = _leaf_to_bytes(arr)
            blobs = [
                raw[off : off + pol.stripe_bytes]
                for off in range(0, max(raw.size, 1), pol.stripe_bytes)
            ]
            if bulk_ec:
                # one batched RSCode.encode_stripes per chunk-length group
                # across all stripes of this leaf, on the cluster's device
                layouts = self.cluster.write_object_bulk(blobs, k=pol.k, m=pol.m)
            else:
                layouts = [
                    self.cluster.write_object(
                        blob,
                        resiliency=pol.resiliency,
                        k=pol.k,
                        m=pol.m,
                        strategy=pol.strategy,
                    )
                    for blob in blobs
                ]
            stripes = [
                {"oid": layout.object_id, "size": int(blob.size)}
                for layout, blob in zip(layouts, blobs)
            ]
            manifest["leaves"].append(
                {"path": path, "meta": meta, "stripes": stripes,
                 "mac": _mac(raw, self.cluster.meta.authority.key),
                 "bytes": int(raw.size)}
            )
        with self._lock:
            self._manifests[step] = manifest
        self.save_seconds.append(time.time() - t0)

    def wait(self) -> None:
        if self._pending is not None and self._pending.is_alive():
            with span("ckpt.wait", wait=True):
                self._pending.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    # -- restore ------------------------------------------------------------------

    def latest_step(self) -> int | None:
        with self._lock:
            return max(self._manifests) if self._manifests else None

    def restore(self, step: int | None = None, treedef: Any = None) -> Any:
        """Read back a checkpoint (degraded-mode capable) as CPU tensors; in
        ``treedef``'s structure (a template tree) when given, else as
        {path: tensor}."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints saved")
        manifest = self._manifests[step]
        out: dict[str, torch.Tensor] = {}
        with span("ckpt.restore", rid=step, leaves=len(manifest["leaves"]),
                  bytes=sum(leaf["bytes"] for leaf in manifest["leaves"])):
            for leaf in manifest["leaves"]:
                # All stripes of the leaf read (and, degraded, reconstructed)
                # together: read_objects batches every same-pattern stripe
                # through ONE RSCode.decode_stripes call.
                layouts = [self.cluster.meta.lookup(s["oid"])
                           for s in leaf["stripes"]]
                raws = self.cluster.read_objects(layouts)
                with span("ckpt.assemble", bytes=leaf["bytes"]):
                    raw = np.empty(leaf["bytes"], np.uint8)
                    off = 0
                    for got, stripe in zip(raws, leaf["stripes"]):
                        raw[off : off + stripe["size"]] = np.frombuffer(
                            got, np.uint8, count=stripe["size"])
                        off += stripe["size"]
                    if _mac(raw, self.cluster.meta.authority.key) != leaf["mac"]:
                        raise IOError(f"integrity check failed for {leaf['path']}")
                    out[leaf["path"]] = _bytes_to_leaf(raw, leaf["meta"])
        if treedef is None:
            return out
        return unflatten(treedef, out)
