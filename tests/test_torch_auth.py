"""The port's bulk capability verifier against the host MAC, on the CPU.

``ops.bulk_verify_tags`` is a batched torch ARX (int64 words masked to 32
bits); it must equal ``core.auth.sponge_mac(xp=np)`` bit for bit, as the
reference's jnp verifier is held to it in ``tests/test_auth.py``.
"""

import numpy as np
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_shim import given, settings
    from _hypothesis_shim import strategies as st

from repro.core.auth import CAP_WORDS, CapabilityAuthority, Rights, sponge_mac
from repro_torch.kernels import ops

CPU = "cpu"
AUTH = CapabilityAuthority(b"0123456789abcdef")


def _cap(**kw):
    args = dict(client_id=7, object_id=42, offset=0, length=1 << 20,
                rights=int(Rights.READ | Rights.WRITE), expiry=2_000_000_000)
    args.update(kw)
    return AUTH.issue(**args)


@given(st.lists(st.lists(st.integers(min_value=0, max_value=2**32 - 1),
                         min_size=CAP_WORDS, max_size=CAP_WORDS), min_size=1, max_size=9),
       st.lists(st.integers(min_value=0, max_value=2**32 - 1), min_size=4, max_size=4))
@settings(max_examples=25, deadline=None)
def test_bulk_verify_tags_equal_host_mac(words, key):
    w = np.array(words, dtype=np.uint32)
    k = np.array(key, dtype=np.uint32)
    got = ops.bulk_verify_tags(w, k, device=CPU)
    assert got.dtype == torch.uint32 and got.shape == (len(words), 2)
    want = sponge_mac(w, k, xp=np)
    assert np.array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))


def test_bulk_verify_tags_take_uint32_tensors():
    w = np.random.default_rng(0).integers(0, 2**32, (5, CAP_WORDS), dtype=np.uint32)
    got = ops.bulk_verify_tags(torch.from_numpy(w), torch.from_numpy(AUTH.key.copy()), device=CPU)
    assert np.array_equal(got.to(torch.int64).numpy(),
                          sponge_mac(w, AUTH.key).astype(np.int64))


def test_bulk_verify_kernel():
    caps = [_cap(client_id=i, nonce=i) for i in range(16)]
    w = np.stack([c.words() for c in caps])
    t = np.array([c.tag for c in caps], dtype=np.uint32)
    ok = ops.bulk_verify(w, t, AUTH.key, device=CPU)
    assert ok.dtype == torch.bool and ok.shape == (16,)
    assert bool(ok.all())
    t[3, 1] ^= 1
    ok2 = ops.bulk_verify(w, t, AUTH.key, device=CPU)
    assert not ok2[3] and int(ok2.sum()) == 15
