"""Composable storage-policy API (see :mod:`repro_torch.policy.spec`).

The port holds the declarative :class:`PolicySpec` and its functional
lowering (:mod:`repro_torch.policy.functional`) that the storage cluster
and the DFS node consume.  The timed pipeline compiler lives in the
simulator, which is not ported.
"""

from repro_torch.policy.spec import (  # noqa: F401
    Chain,
    FailureModel,
    Flat,
    HostAuth,
    METADATA_OPS,
    NoAuth,
    PolicySpec,
    PRESET_NAMES,
    Quorum,
    ReadPolicy,
    RS,
    SpongeAuth,
    Tree,
    preset_spec,
)
