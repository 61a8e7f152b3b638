"""The synthetic AIR family: ``SyntheticAir(uniform_shape(...))`` of the
upstream stark-backend's ``benchmarks/synthetic`` (the repo's ``bench.py``
shape), on traces of uniformly random field elements with the kill column
zero, which makes every row a valid witness (the AIR's constraints and
interactions are multiplied by that column)."""

from __future__ import annotations

import torch

from reference.fields.babybear import P


def _shape(mod, cfg):
    a = cfg["air"]
    return mod.uniform_shape(a["log_height"], a["width"], num_constraints=a["num_constraints"],
                             num_interactions=a["num_interactions"], degree=a["degree"])


def program_air(cfg):
    from swirl_torch.testing import synthetic

    return synthetic.SyntheticAir(_shape(synthetic, cfg))


def reference_air(cfg):
    from reference.testing import synthetic

    return synthetic.SyntheticAir(_shape(synthetic, cfg))


def device_trace(cfg, width: int, seed: int, device) -> torch.Tensor:
    """The (width, 2^log_height) int64 trace of ``seed``, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    trace = torch.randint(0, P, (width, 1 << cfg["air"]["log_height"]), generator=gen, device=device,
                          dtype=torch.int64)
    trace[cfg["air"]["kill_column"]] = 0
    return trace
