"""The reth atlas replay's inputs, and which segments fit on one card.

``runner_params`` and ``sample`` are ``benchmarks/synthetic_runner.py``'s
parameters and sample; ``seeded_traces`` a valid random witness for
SyntheticAirs. As a script it prints the memory model's estimate of each
sampled segment's prove, every AIR at its atlas height, under the
runner's parameters and the default ``ProverConfig``. It runs keygen and
the model on the host and touches no device:

    python -m swirl_torch.tools.segment_fit [--atlas PATH] [--max-log-height 22]
        [--sample-frac 0.1] [--seed 42] [--segments 13,204] [--hbm-gb 80]

The sample is ``benchmarks/synthetic_runner.py``'s (:60-63): the first
``ceil(n * frac)`` of the segments' indices shuffled by
``random.Random(seed)``, or the atlas's ``segment_idx`` values given by
``--segments``. For each segment it prints the AIRs, the main cells, the
GKR leaves, the estimate's terms (GB), the term that sets it, and whether
it fits in ``--hbm-gb``.
"""

from __future__ import annotations

import argparse
import math
import os
import random

ATLAS = os.path.join("benchmarks", "reth-block-23992138-atlas.json")


def runner_params(max_log_height: int, degree: int):
    """The parameters ``benchmarks/synthetic_runner.py`` (:66-85) proves a
    reth segment under: the app preset up to degree 3, else the same
    shape (l_skip 4, log_blowup 1, w_stack 2048, unique decoding, folding
    and mu grinds of 5 and 15 bits) at the segment's degree."""
    from ..params import (
        WhirProximityStrategy,
        app_params_with_100_bits_security,
        params_with_100_bits_security,
    )

    if degree <= 3:
        return app_params_with_100_bits_security(max_log_height)
    return params_with_100_bits_security(
        log_blowup=1,
        l_skip=4,
        n_stack=max(max_log_height - 4, 0),
        w_stack=2048,
        folding_pow_bits=5,
        mu_pow_bits=15,
        proximity=WhirProximityStrategy("unique"),
        max_constraint_degree=degree,
    )


def sample(segments: list, frac: float, seed: int, wanted=None) -> list:
    """The runner's sample of ``segments`` (list positions, sorted)."""
    if wanted is not None:
        return [i for i, s in enumerate(segments) if s["segment_idx"] in wanted]
    idxs = list(range(len(segments)))
    random.Random(seed).shuffle(idxs)
    return sorted(idxs[: math.ceil(len(segments) * frac)])


def seeded_traces(airs, seed: int = 0) -> list:
    """A random witness for each SyntheticAir (of either package: it reads
    ``shape.log_height`` and ``width``), from one seeded generator: every
    column but the kill column (column 0, which stays zero) holds values
    below P. Every SyntheticAir constraint and interaction count is a
    multiple of the kill column, so the traces are valid while their
    messages, denominators and constraint terms are not zero."""
    import numpy as np

    from ..fields.babybear import P

    rng = np.random.default_rng(seed)
    traces = []
    for air in airs:
        trace = rng.integers(0, P, (1 << air.shape.log_height, air.width), dtype=np.uint64)
        trace[:, 0] = 0
        traces.append(trace)
    return traces


def segment_estimate(params, seg: dict):
    """(counts, memory config, estimate) of one prove of ``seg``'s AIRs at their atlas
    heights, under the default ``ProverConfig``'s memory policy."""
    from ..keygen import MultiStarkKeygenBuilder
    from ..memory_metering import ProvingMemoryConfig, counts_for
    from ..testing.synthetic import SyntheticAir

    builder = MultiStarkKeygenBuilder(params, None)
    for shape in seg["shapes"]:
        builder.add_air(SyntheticAir(shape))
    vk = builder.generate_pk().get_vk()
    counts = counts_for(vk, [1 << sh.log_height for sh in seg["shapes"]])
    # ProverConfig() resolves zerocheck_save_memory to log_blowup == 1
    cfg = ProvingMemoryConfig.from_params(params, zerocheck_save_memory=params.log_blowup == 1)
    return counts, cfg, cfg.estimate(counts)


def main(argv=None) -> int:
    from ..testing.synthetic import load_segment_atlas

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--atlas", default=ATLAS)
    ap.add_argument("--max-log-height", type=int, default=22)
    ap.add_argument("--sample-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--segments", default=None, help="comma-separated segment_idx values")
    ap.add_argument("--hbm-gb", type=float, default=80.0)
    args = ap.parse_args(argv)

    segments = load_segment_atlas(args.atlas, args.max_log_height)
    wanted = None if args.segments is None else {int(x) for x in args.segments.split(",")}
    picked = sample(segments, args.sample_frac, args.seed, wanted)
    # the runner proves its whole sample under one degree: the largest
    degree = max((segments[i].get("max_constraint_degree", 3) for i in picked), default=3)
    params = runner_params(args.max_log_height, degree)
    print(f"{len(picked)} of {len(segments)} segments, degree {degree}, clamp 2^{args.max_log_height}; GB")
    print("segment | AIRs | main cells | GKR leaves | main + stacked + rs | batch (round 0: AIR) | gkr | "
          f"whir | commit | total | set by | fits {args.hbm_gb:g}")
    gb = 1e9
    for i in picked:
        seg = segments[i]
        counts, cfg, est = segment_estimate(params, seg)
        base = est.main + est.stacked_matrix + est.rs_code_matrix
        terms = {"batch": est.batch_constraint, "gkr": est.gkr, "whir": est.whir}
        set_by = "commit" if est.commit == est.total else max(terms, key=terms.get)
        largest = max(range(len(counts.round0_airs)), key=lambda k: cfg.round0_memory_bytes(*counts.round0_airs[k]))
        print(f"{seg['segment_idx']} | {len(seg['shapes'])} | {counts.main_cells} | {counts.interaction_cells} | "
              f"{base / gb:.1f} | {est.batch_constraint / gb:.1f} ({seg['shapes'][largest].air_name}) | "
              f"{est.gkr / gb:.1f} | {est.whir / gb:.1f} | {est.commit / gb:.1f} | {est.total / gb:.1f} | "
              f"{set_by} | {est.total <= args.hbm_gb * gb}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
