"""Reed-Solomon erasure coding: RS(k, m) encode/decode + streaming dataflow.

Paper section VI: data is split into ``k`` chunks stored with ``m`` parity
chunks; RS is MDS (any ``m`` losses recoverable) and systematic (data chunks
stored verbatim).  The paper's sPIN-TriEC contribution is *streaming*
encoding: intermediate parities are computed per network packet at the data
nodes and XOR-aggregated at the parity nodes, instead of waiting for whole
chunks (INEC-TriEC) — see :class:`TriECDataNode` / :class:`TriECParityNode`.

The bulk math is delegated to ``repro_torch.kernels.ops`` (hand-written
CUDA kernels on the card, their plain PyTorch versions on the CPU); this
module adds the coding-theory layer (generator matrices, decode solvers,
chunking) and the per-packet dataflow objects used by the functional DFS
node (core/handlers.py).

``backend="torch"`` takes a ``device``: ``"cuda"`` by default, which
raises without a GPU; ``device="cpu"`` runs the kernels' plain versions.
Arrays go in and come out as numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import gf256
from repro_torch.trace.host import span


@dataclasses.dataclass(frozen=True)
class RSCode:
    """A systematic RS(k, m) code over GF(2^8).

    ``encode`` / ``decode`` operate on byte matrices of shape (k, chunk_len):
    row ``j`` is data chunk ``j``.  All chunks of one stripe share a length.
    """

    k: int
    m: int
    kind: str = "cauchy"

    def __post_init__(self):
        if self.k < 1 or self.m < 0 or self.k + self.m > gf256.FIELD_SIZE:
            raise ValueError(f"invalid RS({self.k},{self.m})")

    @property
    def n(self) -> int:
        return self.k + self.m

    @property
    def parity_matrix(self) -> np.ndarray:
        return _parity_matrix_cached(self.k, self.m, self.kind)

    @property
    def parity_bitmatrix(self) -> np.ndarray:
        """(m, k, 8, 8) bit-matrices for the bit-sliced kernel."""
        return gf256.parity_bitmatrix(self.parity_matrix)

    @property
    def generator(self) -> np.ndarray:
        return np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.parity_matrix], axis=0
        )

    # -- whole-stripe paths ------------------------------------------------

    def encode(
        self, data: np.ndarray, backend: str = "numpy", device=DEFAULT_DEVICE
    ) -> np.ndarray:
        """(k, L) data bytes -> (m, L) parity bytes.

        backend="numpy" uses the host LUT path (the paper's per-byte table
        walk, vectorized); backend="torch" routes through kernels/ops.py
        (the CUDA kernel on ``device``, its plain version on the CPU).
        """
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data chunks, got {data.shape[0]}")
        if self.m == 0:
            return np.zeros((0, data.shape[1]), dtype=np.uint8)
        if backend == "numpy":
            return gf256.gf_matmul(self.parity_matrix, data)
        if backend == "torch":
            from repro_torch.kernels import ops

            return _host(ops.rs_encode_stripes(
                data[None], self.k, self.m, kind=self.kind, device=device
            )[0])
        raise ValueError(f"unknown backend {backend!r}")

    def encode_stripes(
        self, data: np.ndarray, backend: str = "torch", device=DEFAULT_DEVICE
    ) -> np.ndarray:
        """Batched encode: (S, k, L) data -> (S, m, L) parity.

        backend="torch" is one kernel launch for the whole batch on
        ``device`` (kernels/ops.py); backend="numpy" is the vectorized host
        LUT path.
        """
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (S, {self.k}, L) stripes, got {data.shape}")
        s, _, length = data.shape
        if self.m == 0:
            return np.zeros((s, 0, length), dtype=np.uint8)
        with span("ec.encode", stripes=s, bytes=data.nbytes):
            if backend == "numpy":
                flat = data.transpose(1, 0, 2).reshape(self.k, s * length)
                out = gf256.gf_matmul(self.parity_matrix, flat)
                return out.reshape(self.m, s, length).transpose(1, 0, 2)
            if backend == "torch":
                from repro_torch.kernels import ops

                return _host(ops.rs_encode_stripes(
                    data, self.k, self.m, kind=self.kind, device=device
                ))
        raise ValueError(f"unknown backend {backend!r}")

    def decode(
        self,
        shards: Sequence[np.ndarray | None],
        backend: str = "numpy",
        device=DEFAULT_DEVICE,
    ) -> np.ndarray:
        """Reconstruct (k, L) data from any >= k surviving shards.

        ``shards`` has length k+m; missing shards are None.  Shard ``i < k``
        is data chunk ``i``; shard ``k + i`` is parity row ``i``.
        """
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise ValueError(
                f"unrecoverable: only {len(present)} of >= {self.k} shards present"
            )
        missing_data = [i for i in range(self.k) if shards[i] is None]
        if not missing_data:
            return np.stack([np.asarray(shards[i], dtype=np.uint8) for i in range(self.k)])
        rows = present[: self.k]
        sub = self.generator[rows]  # (k, k) — invertible because MDS
        inv = gf256.gf_mat_inv(sub)
        stacked = np.stack([np.asarray(shards[i], dtype=np.uint8) for i in rows])
        if backend == "torch":
            from repro_torch.kernels import ops

            return _host(ops.gf_matmul_bytes(inv, stacked, device=device))
        return gf256.gf_matmul(inv, stacked)

    def decode_stripes(
        self,
        shards: Sequence[np.ndarray | None],
        backend: str = "torch",
        device=DEFAULT_DEVICE,
    ) -> np.ndarray:
        """Batched decode: reconstruct (S, k, L) data from surviving shards.

        ``shards`` has length k+m like :meth:`decode`, but each present
        entry is a (S, L) batch (the same erasure pattern applies to every
        stripe — the common whole-node-failure case).  One kernel launch
        recovers all S stripes.
        """
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shard slots, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise ValueError(
                f"unrecoverable: only {len(present)} of >= {self.k} shards present"
            )
        with span("ec.decode") as sp:
            missing_data = [i for i in range(self.k) if shards[i] is None]
            rows = present[: self.k] if missing_data else list(range(self.k))
            stacked = np.stack(
                [np.asarray(shards[i], dtype=np.uint8) for i in rows], axis=1
            )  # (S, k, L)
            if sp:
                sp.set(stripes=stacked.shape[0], bytes=stacked.nbytes)
            if not missing_data:
                return stacked
            inv = gf256.gf_mat_inv(self.generator[rows])
            if backend == "torch":
                from repro_torch.kernels import ops

                return _host(ops.gf_matmul_bytes_batched(inv, stacked, device=device))
            s, _, length = stacked.shape
            flat = stacked.transpose(1, 0, 2).reshape(self.k, s * length)
            out = gf256.gf_matmul(inv, flat)
            return out.reshape(self.k, s, length).transpose(1, 0, 2)

    def reconstruct_shard(
        self, shards: Sequence[np.ndarray | None], index: int
    ) -> np.ndarray:
        """Rebuild one shard (data or parity) from any k survivors."""
        data = self.decode(shards)
        if index < self.k:
            return data[index]
        return gf256.gf_matmul(self.parity_matrix[index - self.k : index - self.k + 1], data)[0]


def _host(result) -> np.ndarray:
    """A kernel's result as a numpy array, inside a ``copy.d2h`` host span
    where it comes off a device."""
    if result.device.type == "cpu":
        return result.numpy()
    with span("copy.d2h", bytes=result.numel() * result.element_size()):
        return result.cpu().numpy()


_PARITY_CACHE: dict[tuple[int, int, str], np.ndarray] = {}


def _parity_matrix_cached(k: int, m: int, kind: str) -> np.ndarray:
    key = (k, m, kind)
    if key not in _PARITY_CACHE:
        if kind == "cauchy":
            _PARITY_CACHE[key] = gf256.cauchy_parity_matrix(k, m)
        elif kind == "vandermonde":
            _PARITY_CACHE[key] = gf256.vandermonde_parity_matrix(k, m)
        else:
            raise ValueError(f"unknown generator kind {kind!r}")
    return _PARITY_CACHE[key]


# ---------------------------------------------------------------------------
# Stripe chunking: split a byte blob into k chunks (+ padding).
# ---------------------------------------------------------------------------


def split_stripe(blob: bytes | np.ndarray, k: int, align: int = 32) -> np.ndarray:
    """Split a blob into (k, L) with L a multiple of ``align`` (zero-padded)."""
    arr = np.frombuffer(bytes(blob), dtype=np.uint8) if isinstance(blob, (bytes, bytearray)) else np.asarray(blob, dtype=np.uint8).ravel()
    chunk = -(-arr.size // k)
    chunk = -(-chunk // align) * align
    out = np.zeros((k, chunk), dtype=np.uint8)
    flat = out.reshape(-1)
    flat[: arr.size] = arr
    return out


def join_stripe(chunks: np.ndarray, orig_size: int) -> bytes:
    """Inverse of :func:`split_stripe`."""
    return np.asarray(chunks, dtype=np.uint8).reshape(-1)[:orig_size].tobytes()


# ---------------------------------------------------------------------------
# Streaming (per-packet) TriEC dataflow — the paper's contribution.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IntermediateParity:
    """One intermediate parity packet: g[i, j] * data_packet from data node j."""

    seq: int          # aggregation sequence id (packet index i in the paper)
    data_index: int   # which data node produced it (j)
    parity_index: int  # which parity node it targets (i)
    payload: np.ndarray


class TriECDataNode:
    """Streaming encoder at a data node (paper Fig. 13 right, 'sending').

    For every incoming packet of its data chunk, produces ``m`` intermediate
    parity packets (one per parity node) — the per-packet payload-handler
    work.  The GF multiply uses the LUT path on host; per-packet cost for the
    simulator is modeled in sim/pspin.py from the paper's measured handler
    instruction counts.
    """

    def __init__(self, code: RSCode, data_index: int):
        self.code = code
        self.data_index = data_index
        self._coeffs = code.parity_matrix[:, data_index]  # (m,)

    def process_packet(self, seq: int, payload: np.ndarray) -> list[IntermediateParity]:
        payload = np.asarray(payload, dtype=np.uint8)
        # One broadcast LUT multiply for all m parity targets at once.
        encs = gf256.gf_mul_vec(payload[None, :], self._coeffs[:, None])
        return [
            IntermediateParity(seq, self.data_index, i, encs[i])
            for i in range(self.code.m)
        ]


class AccumulatorPool:
    """Fixed pool of packet-sized XOR accumulators (paper section VI-B3).

    The header handler allocates an accumulator per aggregation sequence; if
    the pool is exhausted the caller must fall back to CPU aggregation
    (signalled by ``allocate`` returning None).
    """

    def __init__(self, num_accumulators: int, payload_size: int):
        self.capacity = num_accumulators
        self.payload_size = payload_size
        self._free = list(range(num_accumulators))
        self._bufs = np.zeros((num_accumulators, payload_size), dtype=np.uint8)
        self._counts = np.zeros(num_accumulators, dtype=np.int64)
        self.high_watermark = 0

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def allocate(self) -> int | None:
        if not self._free:
            return None
        idx = self._free.pop()
        self._bufs[idx] = 0
        self._counts[idx] = 0
        self.high_watermark = max(self.high_watermark, self.in_use)
        return idx

    def xor_into(self, idx: int, payload: np.ndarray) -> int:
        """Atomic-XOR the payload into accumulator ``idx``; returns count."""
        p = np.asarray(payload, dtype=np.uint8)
        self._bufs[idx, : p.size] ^= p
        self._counts[idx] += 1
        return int(self._counts[idx])

    def release(self, idx: int) -> np.ndarray:
        out = self._bufs[idx].copy()
        self._free.append(idx)
        return out


class TriECParityNode:
    """Streaming aggregator at a parity node.

    Maintains an on-NIC hash table mapping aggregation-sequence id -> pool
    accumulator; XORs the k intermediate parities of each sequence and emits
    the final parity packet once all k arrived.  Returns (seq, payload) when
    a sequence completes, plus a ``fallback`` list of packets that could not
    get an accumulator (CPU path).
    """

    def __init__(self, code: RSCode, pool: AccumulatorPool):
        self.code = code
        self.pool = pool
        self._table: dict[int, int] = {}
        self.fallback: list[IntermediateParity] = []

    def process_packet(self, pkt: IntermediateParity) -> tuple[int, np.ndarray] | None:
        idx = self._table.get(pkt.seq)
        if idx is None:
            idx = self.pool.allocate()
            if idx is None:
                self.fallback.append(pkt)
                return None
            self._table[pkt.seq] = idx
        count = self.pool.xor_into(idx, pkt.payload)
        if count == self.code.k:
            del self._table[pkt.seq]
            return pkt.seq, self.pool.release(idx)
        return None


def stream_encode(
    code: RSCode,
    data: np.ndarray,
    packet_payload: int,
    pool_size: int = 64,
    interleaved: bool = True,
    backend: str = "numpy",
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """End-to-end streaming TriEC encode of a (k, L) stripe — batched.

    Computes the same two-stage dataflow as :func:`stream_encode_packets`
    (data-node intermediate parities -> parity-node XOR aggregation) but
    with every packet of every sequence as one batched op per stage
    instead of a pure-Python per-packet schedule loop.  Must equal
    ``code.encode(data)`` — property-tested.

    Accumulator-pool pressure is modeled analytically from the schedule:
    ``interleaved`` (the paper's section VI-B1 client schedule) delivers
    the k intermediate parities of each aggregation sequence back-to-back,
    so each parity node holds at most one live accumulator; the chunk-major
    schedule keeps every sequence open until its k-th stream arrives, i.e.
    all ``npkts`` accumulators concurrently.  Exceeding ``pool_size``
    raises, exactly like the per-packet path.

    backend="torch" routes both stages through the batched kernels on
    ``device`` (kernels/ops.py): one launch for all m*k intermediate-parity
    streams, one batched XOR-reduce for the m parity-node aggregations.
    """
    data = np.asarray(data, dtype=np.uint8)
    k, length = data.shape
    assert k == code.k
    npkts = -(-length // packet_payload) if packet_payload > 0 else 0
    if code.m == 0 or npkts == 0:
        return np.zeros((code.m, length), dtype=np.uint8)
    concurrent = 1 if (interleaved or k == 1) else npkts
    if concurrent > pool_size:
        # Same failure mode (and count) as the per-packet path: in the
        # chunk-major schedule, sequences >= pool_size fall back during the
        # first k-1 passes; in the final pass the slots freed by completing
        # sequences are re-taken by the next pool_size starved sequences,
        # so only sequences >= 2*pool_size fall back again.
        fallback = (npkts - pool_size) * (k - 1) + max(0, npkts - 2 * pool_size)
        raise RuntimeError(
            f"accumulator pool exhausted ({fallback} packets fell back); "
            "increase pool_size"
        )
    padded = np.zeros((k, npkts * packet_payload), dtype=np.uint8)
    padded[:, :length] = data
    parity_mat = code.parity_matrix
    if backend == "torch":
        from repro_torch.kernels import ops

        # Stage 1, one launch: every (parity, chunk) intermediate stream
        # g[i, j] * chunk_j from the stream-scaling kernel.
        inter = ops.gf_scale_streams(parity_mat, padded, device=device)
        # Stage 2, one launch: batched parity-node aggregation, straight
        # from the device-resident streams.
        parity = _host(ops.xor_reduce_bytes_batched(inter, device=device))
    else:
        inter = gf256.gf_mul_vec(parity_mat[:, :, None], padded[None, :, :])
        parity = np.bitwise_xor.reduce(inter, axis=1)
    return parity[:, :length]


def stream_encode_packets(
    code: RSCode,
    data: np.ndarray,
    packet_payload: int,
    pool_size: int = 64,
    interleaved: bool = True,
) -> np.ndarray:
    """Per-packet reference implementation of the streaming TriEC dataflow
    (client interleaving -> data-node intermediate parities -> parity-node
    aggregation), walking the schedule one packet at a time through the
    :class:`TriECDataNode` / :class:`TriECParityNode` objects.

    ``interleaved`` mirrors the paper's client transmission schedule
    (section VI-B1): packets from the k data chunks are interleaved so
    parity nodes can aggregate each sequence as early as possible.  The
    result is schedule-independent; only accumulator pressure changes.
    This path pins the semantics of the batched :func:`stream_encode`
    (equality property-tested) and backs the accumulator-pressure model.
    """
    data = np.asarray(data, dtype=np.uint8)
    k, length = data.shape
    assert k == code.k
    npkts = -(-length // packet_payload)
    data_nodes = [TriECDataNode(code, j) for j in range(k)]
    pools = [AccumulatorPool(pool_size, packet_payload) for _ in range(code.m)]
    parity_nodes = [TriECParityNode(code, pools[i]) for i in range(code.m)]
    parity = np.zeros((code.m, npkts * packet_payload), dtype=np.uint8)

    if interleaved:
        schedule = [(seq, j) for seq in range(npkts) for j in range(k)]
    else:
        schedule = [(seq, j) for j in range(k) for seq in range(npkts)]

    for seq, j in schedule:
        payload = np.zeros(packet_payload, dtype=np.uint8)
        lo = seq * packet_payload
        actual = data[j, lo : lo + packet_payload]
        payload[: actual.size] = actual
        for ip in data_nodes[j].process_packet(seq, payload):
            done = parity_nodes[ip.parity_index].process_packet(ip)
            if done is not None:
                dseq, dpayload = done
                parity[ip.parity_index, dseq * packet_payload : (dseq + 1) * packet_payload] = dpayload
    for pn in parity_nodes:
        if pn.fallback:
            raise RuntimeError(
                f"accumulator pool exhausted ({len(pn.fallback)} packets fell back); "
                "increase pool_size"
            )
    return parity[:, :length]
