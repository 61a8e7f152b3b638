"""Kernel F (the device transcript's grind, ``csrc/poseidon2.cu``) on the
CPU, by its step model ``p2.grind_model``: the launch plan of
``swirl_p2_grind`` at 132 SMs, the sweep route's candidate lanes (c + k
w-bar, w-bar moved by adds), the rows route through the row permutation's
model, each thread's early exit and the last block's advance, with every
add's operands asserted below P.

- The model equals ``grind_plain`` (witness and advanced state) at every
  absorb cursor for 1 to 12 bits, both routes.
- The model equals the JAX package's ``DeviceTranscript.grind`` (witness,
  state and cursors) at cursors 0, 4 and 7 and 5 and 8 bits.
- The plan at 1 to 30 bits: each sweep's threads take every candidate of
  the sweep once, the rows route up to 10 bits and the sweep route above
  (``PERF.md`` §6), at most 132 x ``GRIND_MIN_BLOCKS`` blocks, and the exit
  rule tries every candidate below a planted witness.
- The constants and the column of M_E the kernel uses, a candidate's work
  in the bound, and the counters a capture owns.

Tolerance: exact equality (finite field).
"""

import os

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from swirl.prover.device_transcript import DeviceTranscript as JaxDeviceTranscript  # noqa: E402
from swirl_torch.fields import field as F  # noqa: E402
from swirl_torch.fields.babybear import P  # noqa: E402
from swirl_torch.hash import poseidon2 as p2  # noqa: E402

U64 = np.uint64
MONT = (1 << 32) % P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's ops are small; one intra-op thread keeps them from
    contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed):
    return F.const_arr(np.random.default_rng(seed).integers(0, P, 16, dtype=np.uint64))


@pytest.mark.parametrize("a", range(8))
@pytest.mark.parametrize("bits", range(1, 13))
def test_grind_model_matches_plain(bits, a):
    st = _state(100 * bits + a)
    got_st, got_w = p2.grind_model(st, a, bits)
    want_st, want_w = p2.grind_plain(st, a, bits)
    assert int(got_w) == int(want_w) >= 0
    assert torch.equal(got_st, want_st)


@pytest.mark.parametrize("bits", [5, 8])
@pytest.mark.parametrize("a", [0, 4, 7])
def test_grind_model_matches_the_jax_device_transcript(a, bits):
    """The JAX package's grind from the same state (Montgomery form there)
    and absorb cursor: the same witness, then the same state and cursors
    after its check_witness."""
    st = _state(7 * a + bits)
    t = JaxDeviceTranscript()
    t.state = jnp.asarray((F.to_host(st) * U64(MONT)) % U64(P), jnp.uint32)
    t.absorb_idx, t.sample_idx = a, 3
    w = int(np.asarray(t.grind(bits, batch=1024)))
    got_st, got_w = p2.grind_model(st, a, bits)
    assert int(got_w) == w
    jax_state = F.from_jax(np.asarray(t.state).reshape(-1))
    assert torch.equal(got_st, jax_state)
    assert (t.absorb_idx, t.sample_idx) == (0, p2.RATE - 1)


@pytest.mark.parametrize("bits", range(1, 31))
def test_grind_plan_sweeps_every_candidate_below_the_witness(bits):
    plan = p2.grind_plan(bits)
    want = p2.GRIND_EXPECTED << bits
    if bits <= 10:
        assert plan["route"] == "rows" and plan["per_sweep"] == want
        assert plan["blocks"] <= 4 * p2.H100_SMS  # at most 4 warps a sub-partition
    else:
        assert plan["route"] == "sweep"
        assert plan["blocks"] == min(want // p2.GRIND_THREADS, p2.H100_SMS * p2.GRIND_MIN_BLOCKS)
    n = plan["per_sweep"]
    offsets = p2.grind_offsets(plan)
    assert offsets.shape[0] == plan["blocks"] * p2.GRIND_THREADS
    assert torch.equal(torch.unique(offsets), torch.arange(n))  # each candidate of a sweep, once
    if plan["route"] == "rows":  # a half-warp's 16 lanes, one candidate
        assert torch.equal(torch.bincount(offsets), torch.full((n,), p2.ROW))
    for witness in sorted({0, n - 1, n + 5, 3 * n + n // 2}):
        tried = []

        def probe(trip, w, alive):
            tried.append(w[w < P])
            return w == witness

        assert p2.grind_search(plan, probe) == witness
        tried = torch.cat(tried)
        assert torch.equal(torch.unique(tried[tried <= witness]), torch.arange(witness + 1))
        assert tried.shape[0] == torch.unique(tried).shape[0]  # no candidate twice


def test_grind_source_constants():
    src = open(os.path.join(os.path.dirname(p2.__file__), "..", "csrc", "poseidon2.cu")).read()
    for name in ("GRIND_THREADS", "GRIND_MIN_BLOCKS", "GRIND_EXPECTED", "GRIND_ROWS_MAX_CANDIDATES"):
        assert f"constexpr int {name} = {getattr(p2, name)};" in src
    assert "__launch_bounds__(GRIND_THREADS, GRIND_MIN_BLOCKS)" in src


@pytest.mark.parametrize("a", range(8))
def test_me_entry_is_the_external_layers_column(a):
    unit = torch.zeros(16, dtype=torch.int64)
    unit[a] = 1
    assert p2._external(unit).tolist() == [p2.me_entry(i, a) for i in range(16)]


def test_grind_candidate_work_counts_the_sweeps_adds():
    """``roofline.GRIND_CANDIDATE``: a permutation less the first M_E and its
    16 constants, plus 20 adds, less the adds of the last M_E that word 7
    does not reach, traced through the kernel's M4 add chain."""
    from swirl_torch import roofline

    made = []

    def add(*parents):
        made.append(parents)
        return len(made) - 1

    def m4(x):  # csrc/poseidon2.cu m4
        t01, t23 = add(x[0], x[1]), add(x[2], x[3])
        t0123 = add(t01, t23)
        t01123, t01233 = add(t0123, x[1]), add(t0123, x[3])
        y1, y3 = add(t01123, add(x[2], x[2])), add(t01233, add(x[0], x[0]))
        return [add(t01123, t01), y1, add(t01233, t23), y3]

    s = [-1 - i for i in range(16)]  # inputs: not adds
    s = [v for g in range(4) for v in m4(s[4 * g : 4 * g + 4])]
    for j in range(4):
        col = add(add(s[j], s[4 + j]), add(s[8 + j], s[12 + j]))
        for g in range(4):
            s[4 * g + j] = add(s[4 * g + j], col)
    reached, todo = set(), [s[7]]
    while todo:
        v = todo.pop()
        if v >= 0 and v not in reached:
            reached.add(v)
            todo.extend(made[v])
    assert len(made) == 72 and len(reached) == 28
    dropped = 72 + 16 + (len(made) - len(reached)) - 20
    assert roofline.GRIND_CANDIDATE == (roofline.PERM[0], roofline.PERM[1] - dropped * roofline.ADD[1])


def test_private_tickets_own_the_grind_pair():
    """Inside ``private_tickets`` the wrappers' counters are the capture's:
    an armed (found word, ticket) pair and zero tower and GKR counters, none
    of any stream's table."""
    cpu = torch.device("cpu")
    with p2.private_tickets(cpu) as own:
        assert p2.tickets(cpu) is own
        assert own.grind.tolist() == [-1, 0] and own.tower.tolist() == [0] and own.gkr.tolist() == [0]
        assert own.grind.dtype == torch.int64 and own.tower.dtype == own.gkr.dtype == torch.int32
        # one allocation: D's counter is the low half of the word after F's
        # pair, K's the low half of the word after D's
        assert own.tower.data_ptr() == own.grind.data_ptr() + 16
        assert own.gkr.data_ptr() == own.grind.data_ptr() + 24
        assert own.grind.untyped_storage().data_ptr() == own.tower.untyped_storage().data_ptr()
        assert own.gkr.untyped_storage().data_ptr() == own.tower.untyped_storage().data_ptr()
    assert getattr(p2._PRIVATE, "own", None) is None


@pytest.mark.parametrize("name,label", [
    ("_ZN45_GLOBAL__N__c3bcb89b_12_poseidon2_cu_990f1f1218grind_sweep_kernelILi7EEEvPljPyS1_",
     "poseidon2.grind_sweep_kernel<7>"),
    ("_ZN45_GLOBAL__N__c3bcb89b_12_poseidon2_cu_990f1f1217grind_rows_kernelEPlijPyS0_", "poseidon2.grind_rows_kernel"),
    ("_ZN40_GLOBAL__N__fc98b2f8_8_bn254_cu_c9a5d47312grind_kernelENS_9GrindArgsEPy", "bn254.grind_kernel"),
])
def test_census_labels_the_grind_kernels(name, label):
    """``tools/isa.py`` names F's two kernels apart, and apart from J's."""
    from swirl_torch.tools import isa

    assert isa.kernel_label(name) == label


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


def _profile(events):
    class Results:
        def events(self):
            return events

    class Prof:
        kineto_results = Results()

    class Outer:
        profiler = Prof()

    return Outer()


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::grind_sweep_kernel<4>(long*, unsigned int, unsigned long long*, long*)",
    "(anonymous namespace)::grind_rows_kernel(long*, int, unsigned int, unsigned long long*, long*)",
])
def test_prove_profile_splits_f_by_width(name):
    """F's device events, one launch a grind on either route, dealt to the
    grinds in order; other kernels and the host's events are not F's."""
    from torch.autograd import DeviceType

    from swirl_torch.tools.prove_profile import grind_widths

    bits = [20, 5, 5, 18]
    events, t = [], 0
    for k, b in enumerate(bits):
        events.append(_Event(name, t, t + 1000 * (k + 1), DeviceType.CUDA))
        t += 10_000
    events.append(_Event("(anonymous namespace)::duplex_kernel(long*)", t, t + 5000, DeviceType.CUDA))
    events.append(_Event("grind_sweep_kernel on the host", 0, 99, DeviceType.CPU))
    got = grind_widths(_profile(events), bits)
    ms = lambda k: (k + 1) / 1000  # noqa: E731
    assert got == {20: (1, ms(0)), 5: (2, ms(1) + ms(2)), 18: (1, ms(3))}
    with pytest.raises(SystemExit):
        grind_widths(_profile(events[:-3]), bits)
