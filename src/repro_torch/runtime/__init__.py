"""Training runtime: so far the straggler monitor
(:mod:`repro_torch.runtime.straggler`), copied from ``repro.runtime``."""
