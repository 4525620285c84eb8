"""Runtime: the serving loop (:mod:`repro_torch.runtime.serve_loop`) and the
straggler monitor (:mod:`repro_torch.runtime.straggler`, copied from
``repro.runtime``).  The training loop and elastic resharding wait for the
training slice of the port."""
