"""Faults planted in the program underneath a run, and the controls, by kind:
what the check has to catch.  Each is a context manager that patches the
program's functions from outside and puts them back.

Training (``train``): ``half`` (the loss over half of the batch's rows, or
half of a single row's positions, the mean taken over those), ``altered``
(each step's loss reported 1% high where it is produced), ``unchanged`` (the
update skipped: every parameter keeps its value).  Its control is the
reference in fp8 (``reference/train_ref.py``), not a patch.

Checkpoints (``ckpt``): ``altered`` (one byte of each encode's parity
flipped), ``half`` (the parity of half of each encode's stripes left zero),
``unchanged`` (the storage nodes keep what they held: writes dropped), and
the control ``control`` (the last parity cell of each object never written,
acknowledged all the same: one acknowledgement fewer than the policy needs).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, attr: str, make):
    old = getattr(owner, attr)
    setattr(owner, attr, make(old))
    try:
        yield
    finally:
        setattr(owner, attr, old)


@contextlib.contextmanager
def train_fault(name: str):
    from repro_torch.launch import steps
    from repro_torch.models import model

    if name == "half":
        def make(loss_fn):
            def half(params, cfg, batch, **kw):
                b, s = batch["tokens"].shape
                cut = (slice(0, b // 2),) if b > 1 else (slice(None), slice(0, s // 2))
                return loss_fn(params, cfg, {k: v[cut] for k, v in batch.items()}, **kw)
            return half
        with patched(model, "loss_fn", make):
            yield
    elif name == "altered":
        def make(loss_fn):
            def altered(*args, **kw):
                value = loss_fn(*args, **kw)
                return value + 0.01 * value.detach()
            return altered
        with patched(model, "loss_fn", make):
            yield
    elif name == "unchanged":
        def make(update):
            def skipped(params, grads, opt_state, cfg, lr_scale=1.0, grad_norm=None):
                return update(params, grads, opt_state, cfg, 0.0 * lr_scale, grad_norm)
            return skipped
        with patched(steps, "adamw_update", make):
            yield
    else:
        raise ValueError(name)


@contextlib.contextmanager
def ckpt_fault(name: str):
    import numpy as np

    from repro_torch.checkpoint import storage
    from repro_torch.core import erasure, handlers

    if name in ("altered", "half"):
        def make(encode):
            def planted(self, data, *args, **kw):
                parity = np.array(encode(self, data, *args, **kw), copy=True)
                if name == "altered":
                    parity[0, 0, 0] ^= 1
                else:
                    parity[: (parity.shape[0] + 1) // 2] = 0
                return parity
            return planted
        with patched(erasure.RSCode, "encode_stripes", make):
            yield
    elif name == "unchanged":
        with patched(handlers.StorageTarget, "write", lambda old: lambda self, addr, data: None):
            yield
    elif name == "control":
        def make(write_shards):
            def fewer(self, lay, chunks, parity):
                before = len(self.client.acks())
                for j, coord in enumerate(lay.data_coords):
                    self.client.write(self.capability, chunks[j], [coord])
                for pi, coord in enumerate(lay.parity_coords[:-1]):
                    self.client.write(self.capability, parity[pi], [coord])
                self._check_acks(lay, before, lay.ec_k + lay.ec_m - 1)
            return fewer
        with patched(storage.StorageCluster, "_write_bulk_shards", make):
            yield
    else:
        raise ValueError(name)


FAULTS = {"train": train_fault, "ckpt": ckpt_fault}
