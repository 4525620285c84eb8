"""Composable storage-policy API (see :mod:`repro_torch.policy.spec`).

One declarative :class:`PolicySpec` drives every plane of the repro:
``repro_torch.policy.timed`` compiles it to a timed stage pipeline on a shared
sim :class:`~repro_torch.sim.protocols.Env`; ``repro_torch.policy.functional`` maps it
onto the byte-accurate handler pipeline of ``repro_torch.core.handlers``; the
checkpoint plane derives its shard encoding from it.
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


#: default request payload for :func:`compile` (the paper's canonical
#: large-write block, Fig. 16)
DEFAULT_REQUEST_BYTES = 1 << 20


def compile(spec, env=None, size=DEFAULT_REQUEST_BYTES, *, engine=None,
            k=4, m=2, strategy=None, window=None,
            cfg=None, pcfg=None, failures=None):
    """Compile a policy into a runnable timed pipeline — the front door.

    Collapses the historical entry points (``make_protocol`` name shims,
    direct ``PipelineProtocol`` construction, per-benchmark Env wiring)
    into one call:

    * ``spec`` — a :class:`PolicySpec`, or a preset name (resolved with
      :func:`preset_spec` using ``k``/``m``/``strategy``).
    * ``env`` — a shared :class:`~repro_torch.sim.protocols.Env` to compile
      onto, or None to build a fresh one from ``cfg``/``pcfg``/
      ``failures``/``engine``.  ``engine`` accepts everything
      :func:`repro_torch.sim.engine.make_engine` does (None == discrete
      default, ``"batched"``, ``"hybrid"``, a class, an instance) and is
      only meaningful when ``compile`` builds the Env.
    * ``size`` — default request payload (``issue(size=...)`` overrides
      per request); ``window`` — INEC host-pacing window.

    Returns the protocol; its Env is reachable as ``proto.env``.
    """
    from repro_torch.policy.timed import compile_policy as _compile
    from repro_torch.sim.protocols import Env

    if isinstance(spec, str):
        from repro_torch.core.packets import ReplStrategy

        spec = preset_spec(
            spec, k=k, m=m,
            strategy=ReplStrategy.RING if strategy is None else strategy,
        )
    if env is None:
        env = Env(cfg, pcfg, failures=failures, engine=engine)
    elif engine is not None or cfg is not None or pcfg is not None \
            or failures is not None:
        raise ValueError(
            "engine/cfg/pcfg/failures apply only when compile() builds "
            "the Env; an existing env already carries them"
        )
    if window is None:
        return _compile(env, spec, size)
    return _compile(env, spec, size, window=window)


def compile_policy(env, spec, size, **kw):
    """Compile ``spec`` to a timed protocol pipeline on ``env``.

    .. deprecated:: PR 9
       Thin alias kept for existing callers — :func:`compile` is the
       facade (it also accepts preset names and builds the Env)."""
    from repro_torch.policy.timed import compile_policy as _compile

    return _compile(env, spec, size, **kw)
