"""The benchmark of ``swirl_torch``: proofs back to back through
``prove_fused(backend, dpk, ctx, mode="segmented")``, one in flight, each on
a fresh trace of the configuration's shape.

A run of one cell (``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``):

1. resolves the cell's configuration, traffic, family and metrics by name
   from ``BENCHMARK.json`` and the files under this directory;
2. refuses to run without as many CUDA cards as the cell asks for;
3. set-up: imports the program, loads its kernel library (built by nvcc
   into the checkout's ``build/`` on its first run there), runs keygen,
   makes the inputs from the seed and makes the first ``prove_fused`` call
   of the cell's shape (eager warm-up, capture, instantiation), recording
   the launches of kernels A-D it makes;
4. the window: proofs back to back until ``--seconds`` have passed, the
   program's spans collected;
5. with ``--trace 1``, one more stretch of proofs under ``torch.profiler``;
6. the check: the program's state freed, a sample of the window's proofs,
   drawn from the seed, judged by the reference under ``reference/``
   (``check``);
7. the result: the cell's metrics, each read by its own file under
   ``metrics/``, as one JSON line, last on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level modules the run may not hold: JAX, and the JAX package and its
# benchmarks (the port's name begins with the JAX package's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "swirl", "benchmarks")
MODE = "segmented"
TRACED = "provebench.traced"  # the profiler's range around the traced proofs
# the program's own CUDA functions sit in an anonymous namespace at the top
KERNEL_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+_kernel)\b")


class HarnessError(Exception):
    """The benchmark cannot run as asked: no card, a missing file."""


# ---------------------------------------------------------------------------
# Resolution: a cell's files, found by name.
# ---------------------------------------------------------------------------


def load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise HarnessError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """The module ``<base>/<kind>/<name>.py``, loaded by path."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise HarnessError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(f"provebench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    family: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` (a parsed ``BENCHMARK.json``) with
    its configuration, traffic, family and metric readers, each from its own
    file under ``root``'s benchmark directory."""
    base = os.path.join(root, os.path.relpath(HERE, ROOT))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    family = load_module("families", config["family"], base)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: load_module("metrics", m["name"], base) for m in e2e + layer}
    return Cell(workload, int(w["chips"]), config, traffic, family, e2e, layer, readers)


def make_params(module, spec: dict):
    """``module``'s preset ``spec["preset"](*spec["args"])``, with the WHIR
    fields in ``spec["whir"]`` replaced (a control's weakening)."""
    params = getattr(module, spec["preset"])(*spec.get("args", []))
    if spec.get("whir"):
        params = dataclasses.replace(params, whir=dataclasses.replace(params.whir, **spec["whir"]))
    return params


# ---------------------------------------------------------------------------
# What a run records, for the metric readers.
# ---------------------------------------------------------------------------


@dataclass
class Profile:
    """The traced stretch: its range on the profiler's clock (ns), the card's
    events (name, start, end) and the host's, and the proofs it holds."""

    lo: int
    hi: int
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    proofs: int


@dataclass
class Run:
    setup_s: float = 0.0
    first_call_s: float = 0.0
    first_call_stats: dict = field(default_factory=dict)
    proofs: int = 0  # proofs in the window
    window_s: float = 0.0  # the first proof's start to the last proof's end
    spans_ms: Dict[str, float] = field(default_factory=dict)  # span -> ms summed over the window
    memory_reserved: int = 0
    launches: Optional[Dict[Tuple[str, tuple], int]] = None  # (kernel, shape) -> launches a proof
    profile: Optional[Profile] = None


def span_ms(run: Run, span: str) -> Optional[float]:
    """A program span's ms a proof over the window, or None."""
    total = run.spans_ms.get(f"{span}_time_ms")
    return None if total is None or not run.proofs else total / run.proofs


def kernel_function(name: str) -> Optional[str]:
    """The CUDA function of one of the program's hand-written kernels in a
    profiler event name (``void (anonymous namespace)::<name>_kernel...``),
    or None."""
    m = KERNEL_NAME.match(name)
    return m.group(1) if m else None


def short_name(name: str) -> str:
    """A device operation's name without its template and argument lists."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    own = kernel_function(name)
    if own:
        return own
    m = re.match(r"(?:void )?([\w:]+)", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name[:80]


# ---------------------------------------------------------------------------
# The device.
# ---------------------------------------------------------------------------


def require_cards(chips: int):
    """The card to run on; raises when there is no CUDA card or fewer than
    ``chips``: a measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise HarnessError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"the cell asks for {chips} cards; {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def recorded_launches():
    """{(kernel, input shape): launches} of the program's hand-written
    kernels launched inside the block (its launch wrapper's counter names);
    the launches themselves unchanged."""
    from collections import Counter

    from swirl_torch import kernels as K

    counts = Counter()
    launch = K.LIB.launch

    def record(kernel, fn_name, t, *args):
        counts[(kernel.name, tuple(t.shape))] += 1
        return launch(kernel, fn_name, t, *args)

    K.LIB.launch = record
    try:
        yield counts
    finally:
        del K.LIB.launch


def per_proof(first_call: dict) -> Optional[Dict[Tuple[str, tuple], int]]:
    """A proof's launches from the first call's: its eager warm-up and its
    capture make the same launches, so every count is even and halves; None
    when one is not."""
    if not first_call or any(n % 2 for n in first_call.values()):
        return None
    return {k: n // 2 for k, n in first_call.items()}


def read_profile(prof, proofs: int) -> Profile:
    """The traced stretch of a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    lo = hi = None
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == TRACED:
                lo, hi = e.start_ns(), e.end_ns()
            else:
                host.append((name, e.start_ns(), e.end_ns()))
        elif name != TRACED:  # the range's mirror on the device's timeline
            device.append((name, e.start_ns(), e.end_ns()))
    if lo is None:
        raise HarnessError("the profiler recorded no range around the traced proofs")
    return Profile(lo, hi, device, host, proofs)


# the profiler's own host events: while the host is in one, the card may
# idle for the trace's sake, not the program's
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request", "Command Buffer Full")


def busy_ns(profile: Profile) -> int:
    from yardstick.busy import Union

    return Union([(s, e) for _, s, e in profile.device]).covered(profile.lo, profile.hi)


def idle_gaps(profile: Profile) -> List[Tuple[int, int]]:
    """The stretches of the traced range in which nothing ran on the card."""
    from yardstick.busy import Union

    busy = Union([(s, e) for _, s, e in profile.device])
    gaps, cur = [], profile.lo
    for s, e in zip(busy.starts, busy.ends):
        if e <= profile.lo or s >= profile.hi:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < profile.hi:
        gaps.append((cur, profile.hi))
    return gaps


def profiler_idle_ns(profile: Profile) -> int:
    """Idle time of the card inside the profiler's own host events."""
    from yardstick.busy import Union

    own = Union([(s, e) for name, s, e in profile.host if name in PROFILER_OWN])
    return sum(own.covered(s, e) for s, e in idle_gaps(profile))


def breakdown(profile: Profile) -> dict:
    """The ten device operations that took most time (by name, seconds) and
    the ten longest idle gaps, each by the innermost host operation open at
    its middle."""
    by_name: Dict[str, int] = {}
    for name, s, e in profile.device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(profile), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_ = [(hs, name) for name, hs, he in profile.host if hs <= mid < he]
        named.append([max(open_)[1] if open_ else "no host operation", (e - s) / 1e9])
    return {"device_ops": [[k, v / 1e9] for k, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def say(*parts) -> None:
    print(*parts, flush=True)


def prove_one(fused, backend, dpk, ctx):
    """One prove of the timed path (a seam for the tests' planted faults)."""
    return fused.prove_fused(backend, dpk, ctx, mode=MODE)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> Tuple[Run, dict, dict]:
    """Set-up, the window, the traced stretch and the check of one run on
    ``device``. Returns (what the run recorded, the check's numbers, the
    window's counts)."""
    import torch

    from swirl_torch import kernels as K
    from swirl_torch import metrics, native
    from swirl_torch import params as tparams
    from swirl_torch.engine import StarkEngine
    from swirl_torch.prover import fused
    from swirl_torch.prover.backend import ProvingContext

    import generator

    run = Run()
    cfg, traffic = cell.config, cell.traffic
    say(f"set-up: import {time.perf_counter() - t0:.3f} s")
    if device.type == "cuda":
        t = time.perf_counter()
        K.LIB.get()
        say(f"set-up: kernel library loaded in {time.perf_counter() - t:.3f} s (build/ of this checkout)")
    say(f"set-up: host library {'loaded' if native.available() else 'absent (numpy)'}")
    spec = cfg["control"]["params"] if control else cfg["params"]
    if control:
        say(f"control: the program proves under {spec}, which breaks: {cfg['control']['breaks']}")
    t = time.perf_counter()
    eng = StarkEngine(make_params(tparams, spec), device=device)
    air = cell.family.program_air(cfg)
    pk, _ = eng.keygen([air])
    dpk = eng.transport_pk(pk)
    say(f"set-up: keygen {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    traces = generator.Traces(cell.family, cfg, traffic, seed, cell.family.reference_air(cfg).common_main_width(),
                              device)
    first = traces.trace(-1)
    sync(device)
    say(f"set-up: inputs {time.perf_counter() - t:.3f} s ({'made on the card a proof' if traces.on_device else f'a pool of {len(traces.pool)} traces'})")
    t = time.perf_counter()
    with recorded_launches() as counts:
        prove_one(fused, eng.backend, dpk, ProvingContext([eng.context_for(0, first)]))
        sync(device)
    run.first_call_s = time.perf_counter() - t
    entry = fused.fused_graphs(dpk, next(iter(getattr(dpk, "_fused_cache", {})), None))
    run.first_call_stats = dict(entry.stats) if entry is not None else {}
    run.launches = per_proof(dict(counts))
    say(f"set-up: first call {run.first_call_s:.3f} s {json.dumps(run.first_call_stats, sort_keys=True)}")
    say(f"set-up: launches of the hand-written kernels a proof {sorted((k, list(s), n) for (k, s), n in (run.launches or {}).items())}")
    del first
    run.setup_s = time.perf_counter() - t0

    # the window: one proof in flight, each on a fresh trace
    proofs: List[Tuple[int, object]] = []
    errors: List[str] = []
    ends: List[float] = []
    attempted = 0
    with metrics.run_with_metric_collection() as collector:
        start = time.perf_counter()
        deadline = start + seconds
        while attempted == 0 or time.perf_counter() < deadline:
            i = attempted
            attempted += 1
            try:
                ctx = ProvingContext([eng.context_for(0, traces.trace(i))])
                proofs.append((i, prove_one(fused, eng.backend, dpk, ctx)))
            except Exception as err:  # a proof that fails counts as failed, and the run goes on
                errors.append(f"proof {i}: {type(err).__name__}: {err}"[:300])
            ends.append(time.perf_counter())
        end = time.perf_counter()
    run.proofs, run.window_s = attempted, end - start
    each = [b - a for a, b in zip([start] + ends, ends)]
    say(f"window: seconds a proof {[round(x, 4) for x in each]}")
    run.spans_ms = {k: v for k, v in collector.snapshot().items() if k.endswith("_time_ms")}
    if device.type == "cuda":
        run.memory_reserved = torch.cuda.max_memory_reserved(device)
    say(f"window: {attempted} proofs in {run.window_s:.3f} s, {len(errors)} failed")
    for e in errors[:3]:
        say(f"window: {e}")

    if trace:
        run.profile = traced_stretch(fused, eng, dpk, traces, attempted, int(traffic["profile_proofs"]), device)

    # the program's state goes before the reference runs
    fused.release_fused(dpk)
    del eng, dpk, pk, air, collector
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, seed, proofs, traces, int(traffic["check_sample"]),
                    os.path.join(ROOT, "build", "provebench") if device.type == "cuda" else None)
    return run, numbers, {"attempted": attempted, "failed": len(errors)}


def traced_stretch(fused, eng, dpk, traces, first_index: int, n: int, device) -> Profile:
    """``n`` more proofs, on the next traces, under ``torch.profiler``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from swirl_torch.prover.backend import ProvingContext

    ctxs = [ProvingContext([eng.context_for(0, traces.trace(first_index + j))]) for j in range(n)]
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED):
            for ctx in ctxs:
                prove_one(fused, eng.backend, dpk, ctx)
            sync(device)
    return read_profile(prof, n)


def check(cell: Cell, seed: int, proofs: List[Tuple[int, object]], traces, sample: int,
          pre_hash_dir: Optional[str] = None) -> dict:
    """The reference's judgement of a sample of the window's proofs, drawn
    from the seed: each one's bytes decoded and verified under the
    configuration's parameters and the reference's own verifying key (every
    stage, the grind witnesses included), and its common main's column
    openings held to the trace's own values at the verifier's point. The
    reference's keygen keeps its vk pre-hash in ``pre_hash_dir`` by the
    hashed bytes' sha256 (a checkout's first run hashes).

    Returns {name: (value, limit)}: proofs rejected, and column openings
    that differ from the trace's; both exact, limit 0."""
    import numpy as np

    from swirl_torch.codec import encode_proof

    from reference import keygen as rkeygen
    from reference import params as rparams
    from reference.codec import decode_proof
    from reference.keygen import MultiStarkKeygenBuilder
    from reference.openings import column_openings
    from reference.verifier import verify

    t = time.perf_counter()
    rkeygen.PRE_HASH_DIR = pre_hash_dir
    params = make_params(rparams, cell.config["params"])

    def no_preprocessed(*_):
        raise HarnessError("the reference's keygen met a preprocessed trace")

    builder = MultiStarkKeygenBuilder(params, no_preprocessed)
    builder.add_air(cell.family.reference_air(cell.config))
    vk = builder.generate_pk().get_vk()
    say(f"check: the reference's keygen {time.perf_counter() - t:.3f} s")
    rotated = vk.per_air[0].params.need_rot
    rng = np.random.default_rng([seed % (1 << 64), 1 << 20])
    picked = sorted(rng.choice(len(proofs), size=min(sample, len(proofs)), replace=False).tolist()) if proofs else []
    rejected = mismatched = 0
    for k in picked:
        i, proof = proofs[k]
        t1 = time.perf_counter()
        try:
            decoded = decode_proof(encode_proof(proof))
            r = verify(params, vk, decoded)
        except Exception as err:  # any refusal, or bytes that do not decode
            rejected += 1
            say(f"check: proof {i} rejected: {type(err).__name__}: {err}"[:400])
            continue
        t2 = time.perf_counter()
        want = column_openings(traces.trace(i), params.l_skip, r, rotated)
        got = np.asarray(decoded.batch_constraint_proof.column_openings[0][0], dtype=np.uint64).reshape(-1, 4)
        bad = len(want) if got.shape != want.shape else int((got != want).any(axis=1).sum())
        mismatched += bad
        say(f"check: proof {i} verified in {t2 - t1:.3f} s; {bad} of {len(want)} column openings differ from its "
            f"trace's ({time.perf_counter() - t2:.3f} s)")
    say(f"check: {len(picked)} of {len(proofs)} proofs (proofs {[proofs[k][0] for k in picked]}) in "
        f"{time.perf_counter() - t:.3f} s")
    return {"proofs_checked": (len(picked), None), "rejected": (rejected, 0), "opening_mismatches": (mismatched, 0)}


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` of :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result(cell: Cell, run: Run, numbers: dict, counts: dict, trace: bool, device) -> dict:
    """The run's line: ``correct``, counts, the metrics its readers give
    (end-to-end ones with ``--trace 0``, per-layer with ``--trace 1``), the
    device, and last the numbers compared with their limits."""
    import torch

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items() if lim is not None}
    correct = (counts["failed"] == 0 and counts["attempted"] > 0 and numbers["proofs_checked"][0] > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_reserved}
    out = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"], "metrics": metrics,
           "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = busy_ns(run.profile) / 1e9
        dev["window_s"] = (run.profile.hi - run.profile.lo) / 1e9
        out["breakdown"] = breakdown(run.profile)
    out["checks"] = compared
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="prove under the configuration's control parameters (it must come out not correct)")
    args = ap.parse_args(argv)
    try:
        cell = resolve(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
        device = require_cards(cell.chips)
        run, numbers, counts = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0, args.control)
        line = result(cell, run, numbers, counts, bool(args.trace), device)
    except HarnessError as err:
        print(f"provebench: {err}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"provebench: the run imported {', '.join(found)}", file=sys.stderr, flush=True)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
