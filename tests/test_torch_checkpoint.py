"""The port's CheckpointManager against the JAX package's, on the CPU.

Every test of ``tests/test_checkpoint.py`` and the manager's test in
``tests/test_degraded.py`` run here on ``repro_torch`` with tensors as
leaves and ``device="cpu"`` clusters.  Beside them: one seeded tree saved
by both managers under one authority key must give equal manifests (MACs
included) and equal bytes in every node's memory; paths must be those
``jax.tree_util`` gives; a tensor mutated in place after ``save`` must not
reach the checkpoint; and a failed background write must raise.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JxManager
from repro.checkpoint.manager import CheckpointPolicy as JxPolicy
from repro.checkpoint.storage import StorageCluster as JxCluster
from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster
from repro_torch.checkpoint import manager as pt_manager
from repro_torch.core.erasure import RSCode
from repro_torch.core.packets import ReplStrategy, Resiliency

CPU = "cpu"


def _cluster(**kw) -> StorageCluster:
    return StorageCluster(device=CPU, **kw)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer0": {"w": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)),
                   "b": torch.zeros(128)},
        "emb": torch.from_numpy(rng.integers(-5, 5, (32, 16)).astype(np.int32)),
        "step": torch.tensor(41),
    }


def _assert_tree_equal(a, b):
    assert torch.equal(a["layer0"]["w"], b["layer0"]["w"])
    assert torch.equal(a["layer0"]["b"], b["layer0"]["b"])
    assert torch.equal(a["emb"], b["emb"])
    assert a["step"] == b["step"]


# -- tests/test_checkpoint.py on the port ------------------------------------------------


def test_ec_checkpoint_survives_m_failures():
    cluster = _cluster(num_nodes=8, node_capacity=1 << 23)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=4, m=2, stripe_bytes=1 << 16))
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    cluster.fail_node(1)
    cluster.fail_node(6)
    _assert_tree_equal(mgr.restore(10, treedef=tree), tree)


def test_ec_checkpoint_fails_beyond_m():
    cluster = _cluster(num_nodes=6, node_capacity=1 << 23)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=4, m=1, stripe_bytes=1 << 16))
    tree = _tree(1)
    mgr.save(1, tree, blocking=True)
    cluster.fail_node(0)
    cluster.fail_node(1)
    cluster.fail_node(2)  # > m failures somewhere in the stripes
    with pytest.raises((ValueError, IOError)):
        mgr.restore(1, treedef=tree)


def test_heal_rebuilds_shards():
    cluster = _cluster(num_nodes=8, node_capacity=1 << 23)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=4, m=2, stripe_bytes=1 << 16))
    tree = _tree(2)
    mgr.save(5, tree, blocking=True)
    cluster.fail_node(3)
    cluster.heal_node(3)            # rebuild from survivors
    cluster.fail_node(0)
    cluster.fail_node(1)            # two NEW failures; healed node must help
    _assert_tree_equal(mgr.restore(5, treedef=tree), tree)


def test_replicated_checkpoint_failover():
    cluster = _cluster(num_nodes=4)
    mgr = CheckpointManager(
        cluster,
        CheckpointPolicy(resiliency=Resiliency.REPLICATION, k=3,
                         strategy=ReplStrategy.PBT, stripe_bytes=1 << 16),
    )
    tree = _tree(3)
    mgr.save(2, tree, blocking=True)
    cluster.fail_node(0)
    cluster.fail_node(1)
    _assert_tree_equal(mgr.restore(2, treedef=tree), tree)


def test_multiple_steps_latest():
    cluster = _cluster(num_nodes=6, node_capacity=1 << 24)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=3, m=1, stripe_bytes=1 << 16))
    t1, t2 = _tree(10), _tree(20)
    mgr.save(1, t1, blocking=True)
    mgr.save(2, t2, blocking=True)
    assert mgr.latest_step() == 2
    _assert_tree_equal(mgr.restore(treedef=t2), t2)
    _assert_tree_equal(mgr.restore(1, treedef=t1), t1)


def test_spill_and_reload_from_disk(tmp_path):
    """Cluster contents + namespace survive a process 'restart' via spill."""
    cluster = _cluster(num_nodes=6, node_capacity=1 << 20, spill_dir=str(tmp_path / "spill"))
    blob = np.random.default_rng(0).integers(0, 256, 50_000, dtype=np.uint8)
    layout = cluster.write_object(blob.tobytes(), k=3, m=2)
    d = cluster.spill()

    revived = StorageCluster.from_spill(d, device=CPU)
    got = revived.read_object(revived.meta.lookup(layout.object_id))
    assert got == blob.tobytes()
    # degraded read still works after reload
    revived.fail_node(layout.data_coords[0].node)
    revived.fail_node(layout.parity_coords[0].node)
    assert revived.read_object(revived.meta.lookup(layout.object_id)) == blob.tobytes()


def test_bulk_client_encode_matches_nic_streaming_path():
    """encode='client' (one batched RSCode.encode_stripes per leaf) must lay
    out byte-identical shards to the per-packet NIC streaming path."""
    blob = np.random.default_rng(7).integers(0, 256, 70_001, dtype=np.uint8)
    a = _cluster(num_nodes=6, node_capacity=1 << 22)
    b = _cluster(num_nodes=6, node_capacity=1 << 22)
    la = a.write_object_bulk([blob.tobytes()], k=3, m=2)[0]
    lb = b.write_object(blob.tobytes(), k=3, m=2)  # NIC streaming EC
    assert la.chunk_len == lb.chunk_len
    for ca, cb in zip(
        list(la.data_coords) + list(la.parity_coords),
        list(lb.data_coords) + list(lb.parity_coords),
    ):
        sa = a.nodes[ca.node].read(ca.addr, la.chunk_len)
        sb = b.nodes[cb.node].read(cb.addr, lb.chunk_len)
        assert np.array_equal(sa, sb)
    assert a.read_object(la) == blob.tobytes()


def test_bulk_encode_roundtrip_under_erasures():
    """The bulk path survives m node losses end to end, and no more."""
    cluster = _cluster(num_nodes=8, node_capacity=1 << 23)
    mgr = CheckpointManager(
        cluster, CheckpointPolicy(k=4, m=2, stripe_bytes=1 << 15, encode="client"))
    tree = _tree(9)
    mgr.save(3, tree, blocking=True)
    cluster.fail_node(2)
    cluster.fail_node(5)
    _assert_tree_equal(mgr.restore(3, treedef=tree), tree)
    # beyond m failures the stripe must be unrecoverable
    cluster.fail_node(0)
    cluster.fail_node(1)
    with pytest.raises((ValueError, IOError)):
        mgr.restore(3, treedef=tree)


def test_manager_accepts_policy_spec():
    """CheckpointManager lowers a declarative PolicySpec directly."""
    from repro_torch.policy import RS, PolicySpec, SpongeAuth

    spec = PolicySpec("spin", SpongeAuth(), erasure=RS(3, 2, "client"))
    cluster = _cluster(num_nodes=6, node_capacity=1 << 23)
    mgr = CheckpointManager(cluster, spec)
    assert mgr.policy.k == 3 and mgr.policy.m == 2
    assert mgr.policy.encode == "client"
    tree = _tree(11)
    mgr.save(1, tree, blocking=True)
    cluster.fail_node(1)
    _assert_tree_equal(mgr.restore(1, treedef=tree), tree)


def test_checkpoint_policy_spec_roundtrip():
    for pol in (
        CheckpointPolicy(k=5, m=3, encode="client"),
        CheckpointPolicy(k=4, m=2, encode="nic"),
        CheckpointPolicy(resiliency=Resiliency.REPLICATION, k=3, strategy=ReplStrategy.PBT),
    ):
        back = CheckpointPolicy.from_spec(pol.spec(), stripe_bytes=pol.stripe_bytes)
        assert back.resiliency == pol.resiliency
        assert back.k == pol.k
        if pol.resiliency == Resiliency.ERASURE_CODING:
            assert back.m == pol.m and back.encode == pol.encode
        else:
            assert back.strategy == pol.strategy


# -- tests/test_degraded.py's manager test on the port ------------------------------------


def test_checkpoint_restore_batches_degraded_decode(monkeypatch):
    """restore routes every same-pattern stripe of a leaf through one
    batched decode_stripes call and survives m losses."""
    cluster = _cluster(num_nodes=8, node_capacity=1 << 23)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=4, m=2, stripe_bytes=1 << 14))
    tree = {"w": torch.from_numpy(
        np.random.default_rng(3).standard_normal((96, 128)).astype(np.float32))}
    mgr.save(1, tree, blocking=True)
    cluster.fail_node(0)
    cluster.fail_node(5)
    calls = []
    decode = RSCode.decode_stripes

    def counted(self, shards, *args, **kwargs):
        calls.append(len(shards[0]) if shards[0] is not None else None)
        return decode(self, shards, *args, **kwargs)

    monkeypatch.setattr(RSCode, "decode_stripes", counted)
    got = mgr.restore(1, treedef=tree)
    assert torch.equal(got["w"], tree["w"])
    # 3 stripes of 16 KiB; each erasure pattern is one batched call
    assert 1 <= len(calls) <= 3


# -- the port against the reference -----------------------------------------------------


def _mixed_tree(seed=5):
    """numpy leaves for ``repro`` and the same bytes as tensors for the port:
    fp32, bf16, int32 and int64 leaves, a list, a tuple and a 0-d step."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((48, 80)).astype(np.float32)
    w16 = rng.standard_normal((33, 64)).astype(ml_dtypes.bfloat16)
    idx = rng.integers(-9, 9, (7, 5)).astype(np.int32)
    moments = [rng.standard_normal((300,)).astype(np.float32) for _ in range(2)]
    step = np.asarray(1234, np.int64)
    jx = {"params": {"w": w, "w16": w16, "zeta": idx}, "opt": moments,
          "pair": (moments[0][:7].copy(), np.arange(5, dtype=np.int64)), "step": step}
    pt = {"params": {"w": torch.from_numpy(w.copy()),
                     "w16": torch.from_numpy(w16.view(np.uint16).copy()).view(torch.bfloat16),
                     "zeta": torch.from_numpy(idx.copy())},
          "opt": [torch.from_numpy(m.copy()) for m in moments],
          "pair": (torch.from_numpy(moments[0][:7].copy()), torch.arange(5)),
          "step": torch.tensor(1234)}
    return jx, pt


def test_paths_and_leaf_order_match_jax_tree_util():
    jx_tree, pt_tree = _mixed_tree()
    jx_tree["none"] = None
    pt_tree["none"] = None
    flat, _ = jax.tree_util.tree_flatten_with_path(jx_tree)
    want = [JxManager._path_str(p) for p, _ in flat]
    assert [pt_manager.path_str(p) for p, _ in pt_manager.flatten(pt_tree)] == want


@pytest.mark.parametrize("encode", ["client", "nic"])
def test_same_tree_and_key_give_identical_manifests_and_node_memories(encode):
    jx_tree, pt_tree = _mixed_tree()
    jx = JxCluster(num_nodes=9, node_capacity=1 << 22)
    pt = _cluster(num_nodes=9, node_capacity=1 << 22)
    # one authority key for both clusters (the nodes share the authority
    # object, so its key is swapped in place and the client re-issued)
    pt.meta.authority.key = jx.meta.authority.key.copy()
    pt.capability = pt.meta.issue_capability(pt.client_id)
    policy = dict(k=4, m=2, stripe_bytes=1 << 12, encode=encode)
    jx_mgr = JxManager(jx, JxPolicy(**policy))
    pt_mgr = CheckpointManager(pt, CheckpointPolicy(**policy))
    jx_mgr.save(7, jx_tree, blocking=True)
    pt_mgr.save(7, pt_tree, blocking=True)
    assert pt_mgr._manifests[7] == jx_mgr._manifests[7]
    assert {leaf["meta"]["dtype"] for leaf in pt_mgr._manifests[7]["leaves"]} == {
        "float32", "bfloat16", "int32", "int64"}
    for a, b in zip(pt.nodes, jx.nodes, strict=True):
        np.testing.assert_array_equal(a.storage.mem, b.storage.mem)
    got = pt_mgr.restore(7, treedef=pt_tree)
    assert isinstance(got["opt"], list) and isinstance(got["pair"], tuple)
    for (_, x), (_, y) in zip(pt_manager.flatten(got), pt_manager.flatten(pt_tree), strict=True):
        assert x.device.type == "cpu" and x.dtype == y.dtype and torch.equal(x, y)


def test_mutating_a_tensor_after_save_does_not_reach_the_checkpoint():
    cluster = _cluster(num_nodes=6, node_capacity=1 << 22)
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=3, m=2, stripe_bytes=1 << 12))
    tree = _tree(4)
    want = {"w": tree["layer0"]["w"].clone(), "emb": tree["emb"].clone()}
    # hold the cluster's I/O lock so the background write cannot start
    # before the training step below mutates the tensors in place
    with cluster._io_lock:
        mgr.save(1, tree, blocking=False)
        tree["layer0"]["w"].add_(1.0)
        tree["emb"].zero_()
    got = mgr.restore(1)
    assert torch.equal(got["layer0/w"], want["w"])
    assert torch.equal(got["emb"], want["emb"])


def test_a_failed_background_write_raises_from_wait():
    cluster = _cluster(num_nodes=6, node_capacity=1 << 12)     # too small for the tree
    mgr = CheckpointManager(cluster, CheckpointPolicy(k=3, m=2, stripe_bytes=1 << 12))
    with pytest.raises(RuntimeError, match="full"):
        mgr.save(1, _tree(), blocking=True)
    assert mgr.latest_step() is None
    mgr.wait()                   # the error is raised once
