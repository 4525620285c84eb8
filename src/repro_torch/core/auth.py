"""Capability-based client request authentication (paper section IV).

Threat model (the paper's): clients are untrusted, the network is trusted.
The metadata service issues *capability tickets* — (client, object extent,
rights, expiry) signed with a key shared among DFS services — and storage
nodes validate the capability in the header handler before accepting the
rest of the request's packets.

The MAC is a keyed ARX sponge over 32-bit words chosen so the exact same
computation runs (a) on the host control plane (numpy), and (b) as a
vectorized bulk verifier inside jitted JAX data paths (e.g. validating a
batch of restore requests in one fused op).  It is *not* a standardized
algorithm; it plays the role of the paper's 200-cycle header-handler check
and of [32]-style capability signatures.  Swapping in HMAC-SHA256 on the
host path is a one-line change (`Capability.mac_backend`).

Rights are a bitmap; extents are byte ranges of an object id.  The verifier
checks signature, expiry, rights superset, and extent containment — the
checks DFS_request_init performs in Listing 1.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

MAC_ROUNDS = 8
_MASK32 = 0xFFFFFFFF


class Rights(enum.IntFlag):
    READ = 1
    WRITE = 2
    APPEND = 4
    DELETE = 8
    ADMIN = 16


def _rotl(x, r, xp):
    r = int(r)
    left = xp.left_shift(x, xp.uint32(r)) if r else x
    right = xp.right_shift(x, xp.uint32(32 - r)) if r != 32 else x
    return (left | right) & xp.uint32(_MASK32)


def sponge_mac(words, key_words, xp=np):
    """Keyed ARX sponge MAC over uint32 words -> (2,) uint32 tag.

    ``words``: (..., W) uint32; ``key_words``: (4,) uint32.  Works with
    ``xp=np`` (host) and ``xp=jnp`` (bulk JAX verifier); both produce
    identical tags (property-tested).
    """
    if xp is np:
        # uint32 wraparound is intended; silence numpy 2.x scalar-overflow
        # warnings for the whole computation.
        import contextlib

        ctx = np.errstate(over="ignore")
        words = np.asarray(words, dtype=np.uint32)
        key = np.asarray(key_words, dtype=np.uint32)
    else:
        import contextlib

        ctx = contextlib.nullcontext()
        words = xp.asarray(words, dtype=xp.uint32)
        key = xp.asarray(key_words, dtype=xp.uint32)

    with ctx:
        batch = words.shape[:-1]
        ones = xp.ones(batch + (1,), dtype=xp.uint32) if batch else None

        def bcast(k):
            return k * ones[..., 0] if ones is not None else k

        v0 = bcast(key[0] ^ xp.uint32(0x736F6D65))
        v1 = bcast(key[1] ^ xp.uint32(0x646F7261))
        v2 = bcast(key[2] ^ xp.uint32(0x6C796765))
        v3 = bcast(key[3] ^ xp.uint32(0x74656462))

        def round_fn(v0, v1, v2, v3):
            v0 = (v0 + v1) & xp.uint32(_MASK32)
            v1 = _rotl(v1, 5, xp) ^ v0
            v0 = _rotl(v0, 16, xp)
            v2 = (v2 + v3) & xp.uint32(_MASK32)
            v3 = _rotl(v3, 8, xp) ^ v2
            v0 = (v0 + v3) & xp.uint32(_MASK32)
            v3 = _rotl(v3, 13, xp) ^ v0
            v2 = (v2 + v1) & xp.uint32(_MASK32)
            v1 = _rotl(v1, 7, xp) ^ v2
            v2 = _rotl(v2, 16, xp)
            return v0, v1, v2, v3

        nwords = words.shape[-1]
        for i in range(nwords):
            w = words[..., i]
            v3 = v3 ^ w
            for _ in range(2):
                v0, v1, v2, v3 = round_fn(v0, v1, v2, v3)
            v0 = v0 ^ w
        v2 = v2 ^ xp.uint32(0xFF)
        for _ in range(MAC_ROUNDS):
            v0, v1, v2, v3 = round_fn(v0, v1, v2, v3)
        t0 = v0 ^ v1
        t1 = v2 ^ v3
        if xp is np:
            return np.stack([t0, t1], axis=-1).astype(np.uint32)
        return xp.stack([t0, t1], axis=-1)


# Capability wire layout (little-endian uint32 words):
#   [0] client_id  [1] object_id_lo [2] object_id_hi
#   [3] extent_off_lo [4] extent_off_hi [5] extent_len_lo [6] extent_len_hi
#   [7] rights  [8] expiry_epoch_s  [9] nonce
CAP_WORDS = 10
_CAP_STRUCT = struct.Struct("<10I")
TAG_WORDS = 2


@dataclasses.dataclass(frozen=True)
class Capability:
    """A signed ticket granting ``rights`` over ``[offset, offset+length)``
    of ``object_id`` to ``client_id`` until ``expiry`` (epoch seconds)."""

    client_id: int
    object_id: int
    offset: int
    length: int
    rights: int
    expiry: int
    nonce: int = 0
    tag: tuple[int, int] = (0, 0)

    def words(self) -> np.ndarray:
        return np.array(
            [
                self.client_id & _MASK32,
                self.object_id & _MASK32,
                (self.object_id >> 32) & _MASK32,
                self.offset & _MASK32,
                (self.offset >> 32) & _MASK32,
                self.length & _MASK32,
                (self.length >> 32) & _MASK32,
                self.rights & _MASK32,
                self.expiry & _MASK32,
                self.nonce & _MASK32,
            ],
            dtype=np.uint32,
        )

    def pack(self) -> bytes:
        return _CAP_STRUCT.pack(*(int(w) for w in self.words())) + struct.pack(
            "<2I", *self.tag
        )

    @staticmethod
    def unpack(raw: bytes) -> "Capability":
        w = _CAP_STRUCT.unpack(raw[: _CAP_STRUCT.size])
        t = struct.unpack("<2I", raw[_CAP_STRUCT.size : _CAP_STRUCT.size + 8])
        return Capability(
            client_id=w[0],
            object_id=w[1] | (w[2] << 32),
            offset=w[3] | (w[4] << 32),
            length=w[5] | (w[6] << 32),
            rights=w[7],
            expiry=w[8],
            nonce=w[9],
            tag=(t[0], t[1]),
        )

    PACKED_SIZE = _CAP_STRUCT.size + 8  # 48 bytes


class CapabilityAuthority:
    """Control-plane issuer/verifier holding the DFS-shared key.

    The metadata service owns an instance and signs tickets; storage-node
    header handlers hold the key and verify (``verify`` is the host path,
    ``repro_torch.kernels.ops.bulk_verify`` the jitted batch path).
    """

    def __init__(self, key: bytes | np.ndarray):
        if isinstance(key, (bytes, bytearray)):
            if len(key) != 16:
                raise ValueError("key must be 16 bytes / 4 words")
            key = np.frombuffer(bytes(key), dtype=np.uint32)
        self.key = np.asarray(key, dtype=np.uint32)
        if self.key.shape != (4,):
            raise ValueError("key must be 4 uint32 words")

    def issue(
        self,
        client_id: int,
        object_id: int,
        offset: int,
        length: int,
        rights: int,
        expiry: int,
        nonce: int = 0,
    ) -> Capability:
        cap = Capability(client_id, object_id, offset, length, rights, expiry, nonce)
        tag = sponge_mac(cap.words(), self.key)
        return dataclasses.replace(cap, tag=(int(tag[0]), int(tag[1])))

    def verify(
        self,
        cap: Capability,
        *,
        now: int,
        op_rights: int,
        offset: int | None = None,
        length: int | None = None,
        client_id: int | None = None,
    ) -> bool:
        """Full header-handler check: MAC, expiry, rights, extent, identity."""
        tag = sponge_mac(cap.words(), self.key)
        if (int(tag[0]), int(tag[1])) != cap.tag:
            return False
        if now > cap.expiry:
            return False
        if (cap.rights & op_rights) != op_rights:
            return False
        if client_id is not None and client_id != cap.client_id:
            return False
        if offset is not None:
            req_len = length if length is not None else 0
            if offset < cap.offset or offset + req_len > cap.offset + cap.length:
                return False
        return True

    def bulk_tags(self, caps_words: np.ndarray, xp=np):
        """(N, CAP_WORDS) -> (N, 2) tags. xp=jnp gives the jittable verifier."""
        key = self.key if xp is np else xp.asarray(self.key)
        return sponge_mac(caps_words, key, xp=xp)
