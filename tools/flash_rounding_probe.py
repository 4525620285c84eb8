#!/usr/bin/env python3
"""Where the flash kernel's bf16 body rounds: its output against three
plain versions that differ only in how the scores are taken.

Run on a machine with a CUDA GPU, from the repository root:

    PYTHONPATH=src python3 tools/flash_rounding_probe.py

For every supported (D, Dv), S in {63, 64, 65, 127, 128, 129, 1500},
causal or not (B=2, H=4, Hkv=2, inputs from numpy seeds as in
``tests/test_torch_cuda.py``), the kernel's bf16 output is held against:

- ``q scaled first``: fp32 q * scale, then fp32 products (the TPU
  kernel's order, and the plain version before the tensor-core body);
- ``scaled after``: fp32 products of the bf16 inputs, then the scale;
- ``tensor-core product``: ``flash_attention_fwd_plain``, bf16 products
  with fp32 sums on the tensor cores, then the scale.

All three walk the body's 128-key tiles and round p to bf16 against the
same running max.  The script prints, per variant, how many shapes exceed
the one-ulp allowance of ``tests/test_torch_cuda.py`` and the largest
share of it any element uses.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import _flash_fwd_scan, _group_q  # noqa: E402

S_VALUES = (63, 64, 65, 127, 128, 129, 1500)


def q_scaled_first(q, k, v, causal):
    qg = _group_q(q.float() * (1.0 / math.sqrt(q.shape[3])), k.shape[2])
    out, _ = _flash_fwd_scan(qg, k, v, causal, fa.KV_TILE, 0)
    return out.reshape(*q.shape[:3], v.shape[3]).to(q.dtype)


def scaled_after(q, k, v, causal):
    qg = _group_q(q.float(), k.shape[2])
    out, _ = _flash_fwd_scan(qg, k, v, causal, fa.KV_TILE, 0, 1.0 / math.sqrt(q.shape[3]))
    return out.reshape(*q.shape[:3], v.shape[3]).to(q.dtype)


def tensor_core_product(q, k, v, causal):
    return fa.flash_attention_fwd_plain(q, k, v, causal)[0]


VARIANTS = {"q scaled first": q_scaled_first, "scaled after": scaled_after,
            "tensor-core product": tensor_core_product}


def share(got, want) -> float:
    """Largest share of the allowance 2^-7 |want| + 1e-3 rms(row) used."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = 2 ** -7 * want.abs() + 1e-3 * want.square().mean(-1, keepdim=True).sqrt()
    return float(torch.where(diff == 0, 0.0, diff / allowed).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_rounding_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    worst = dict.fromkeys(VARIANTS, 0.0)
    over = dict.fromkeys(VARIANTS, 0)
    shapes = 0
    for d, dv in fa.HEAD_DIMS:
        for s in S_VALUES:
            for causal in (True, False):
                rng = np.random.default_rng(d * 1000 + dv + s)
                q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                           .to(device=dev, dtype=torch.bfloat16)
                           for shape in ((2, s, 4, d), (2, s, 2, d), (2, s, 2, dv)))
                got = fa.flash_attention_fwd(q, k, v, causal)
                shapes += 1
                for name, plain in VARIANTS.items():
                    w = share(got, plain(q, k, v, causal))
                    worst[name] = max(worst[name], w)
                    over[name] += w > 1.0
    print(f"card: {torch.cuda.get_device_name(0)}; {shapes} shapes")
    for name in VARIANTS:
        print(f"  {name}: {over[name]} shapes over the allowance, largest share {worst[name]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
