"""The program's ``ModelConfig`` for a configuration file's published keys:
the one place where the benchmark's configurations meet the port's model
code (``port_options`` carries the port's own tilings, such as the loss's
chunk)."""

from __future__ import annotations


def model_config(c: dict, remat: bool):
    """The program's ``ModelConfig`` for a configuration's published keys."""
    from repro_torch.models.model import ModelConfig

    common = dict(name=c.get("name", c["model_type"]), n_layers=c["num_hidden_layers"],
                  d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
                  vocab=c["vocab_size"], rope_theta=float(c["rope_theta"]),
                  norm_eps=c["rms_norm_eps"], remat=remat, **c.get("port_options", {}))
    return ModelConfig(family="dense", n_kv_heads=c["num_key_value_heads"],
                       d_ff=c["intermediate_size"], **common)
