"""The port's storage cluster against the JAX package's, on the CPU.

A ``repro`` cluster and a ``repro_torch`` cluster (``device="cpu"``) get
the same blobs; their node memories must end byte-identical.  State
crosses from ``repro`` to the port as plain numpy arrays and values, the
way a checkpoint written by one package is read by the other.
"""

import numpy as np
import pytest

from repro.checkpoint.storage import StorageCluster as JxCluster
from repro.policy import RS, PolicySpec
from repro_torch.checkpoint.storage import StorageCluster as PtCluster
from repro_torch.policy import RS as PtRS
from repro_torch.policy import PolicySpec as PtPolicySpec

K, M = 3, 2
NODES = 8
CAPACITY = 1 << 22


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (50_000, 1, 4_097, 0, 123_457)]


def _layout_tuple(lay):
    return (lay.object_id, lay.size, int(lay.resiliency), int(lay.strategy),
            [(c.node, c.addr) for c in lay.data_coords],
            [(c.node, c.addr) for c in lay.parity_coords],
            lay.ec_k, lay.ec_m, lay.chunk_len, lay.lost)


def _repro_state(cluster: JxCluster) -> dict:
    """A ``repro`` cluster's state in the port's ``from_state`` format."""
    return {
        "key": bytes(cluster.meta.authority.key.tobytes()),
        "num_nodes": cluster.num_nodes,
        "capacity": cluster.node_capacity,
        "alloc": list(cluster.meta._alloc),
        "next_oid": cluster.meta._next_oid,
        "nodes": [node.storage.mem.copy() for node in cluster.nodes],
        "objects": [
            dict(zip(("object_id", "size", "resiliency", "strategy", "data_coords",
                      "parity_coords", "ec_k", "ec_m", "chunk_len", "lost"),
                     _layout_tuple(lay)))
            for lay in cluster.meta._objects.values()
        ],
    }


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_bulk_write_gives_identical_node_memories(backend):
    blobs = _blobs()
    jx = JxCluster(num_nodes=NODES, node_capacity=CAPACITY)
    pt = PtCluster(num_nodes=NODES, node_capacity=CAPACITY, device="cpu")
    # the reference's host LUT encode: its kernel path is held to the same
    # bytes by its own tests, and the port's kernels by test_torch_dataplane
    jx_layouts = jx.write_object_bulk(blobs, k=K, m=M, backend="numpy")
    pt_layouts = pt.write_object_bulk(blobs, k=K, m=M, backend=backend)
    assert [_layout_tuple(a) for a in pt_layouts] == [_layout_tuple(b) for b in jx_layouts]
    for a, b in zip(pt.nodes, jx.nodes, strict=True):
        np.testing.assert_array_equal(a.storage.mem, b.storage.mem)
    assert pt.read_objects(pt_layouts) == blobs


def test_client_ec_spec_write_matches_reference():
    blob = _blobs(1)[0]
    spec = PolicySpec(erasure=RS(K, M, engine="client"))
    jx = JxCluster(num_nodes=NODES, node_capacity=CAPACITY)
    pt = PtCluster(num_nodes=NODES, node_capacity=CAPACITY, device="cpu")
    jx.write_object(blob, spec=spec)
    pt.write_object(blob, spec=PtPolicySpec(erasure=PtRS(K, M, engine="client")))
    for a, b in zip(pt.nodes, jx.nodes, strict=True):
        np.testing.assert_array_equal(a.storage.mem, b.storage.mem)


@pytest.mark.parametrize("lost", [(0, 1), (0, 3), (3, 4)])
def test_state_from_reference_cluster_reads_back_degraded(lost):
    blobs = _blobs(2)
    jx = JxCluster(num_nodes=NODES, node_capacity=CAPACITY)
    jx.write_object_bulk(blobs, k=K, m=M)
    state = _repro_state(jx)
    pt = PtCluster.from_state(state, device="cpu")
    assert pt.to_state()["objects"] == state["objects"]
    layouts = list(pt.meta._objects.values())
    coords = list(layouts[0].data_coords) + list(layouts[0].parity_coords)
    for slot in lost:
        pt.fail_node(coords[slot].node)
    assert pt.read_objects(layouts, verify=True) == blobs
    # the authenticated packet plane works under the carried key: new writes land
    more = pt.write_object_bulk([b"after the move"], k=K, m=M)
    assert pt.read_objects(more) == [b"after the move"]


def test_state_round_trip_within_the_port():
    blobs = _blobs(3)
    pt = PtCluster(num_nodes=NODES, node_capacity=CAPACITY, device="cpu")
    layouts = pt.write_object_bulk(blobs, k=K, m=M)
    again = PtCluster.from_state(pt.to_state(), device="cpu")
    assert [_layout_tuple(a) for a in again.meta._objects.values()] == \
        [_layout_tuple(b) for b in layouts]
    assert again.read_objects(list(again.meta._objects.values())) == blobs


def test_degraded_read_verify_catches_corruption():
    blob = _blobs(4)[0]
    cluster = PtCluster(num_nodes=NODES, node_capacity=CAPACITY, device="cpu")
    layout = cluster.write_object_bulk([blob], k=K, m=M)[0]
    par = layout.parity_coords[1]
    cluster.nodes[par.node].storage.mem[par.addr] ^= 0xFF
    cluster.fail_node(layout.data_coords[0].node)
    with pytest.raises(IOError, match="reconstruction mismatch"):
        cluster.read_object(layout)
    assert cluster.read_object(layout, verify=False) == blob


def test_too_many_losses_raise_ioerror():
    blob = _blobs(5)[0]
    cluster = PtCluster(num_nodes=NODES, node_capacity=CAPACITY, device="cpu")
    layout = cluster.write_object_bulk([blob], k=K, m=M)[0]
    for coord in list(layout.data_coords)[:2] + list(layout.parity_coords)[:1]:
        cluster.fail_node(coord.node)
    with pytest.raises(IOError, match="unrecoverable"):
        cluster.read_object(layout)
