"""The readers of the commit's and WHIR's kernels on a hand-made run: the
RS encodes' and the Merkle builds' device time a proof, and kernels A and
A′'s share of their roofline, against hand-computed values; nothing where
the run has no timing or no trace (as a parent without them); and the
share counts NTT launches and NTT functions alone."""

import pytest

import harness
from yardstick import roofline as y


def reader(name):
    return harness.load_module("metrics", name)


def _profile(device, hi, proofs):
    return harness.Profile(0, hi, list(device), [], proofs)


SPANS = {"pcs.encode.device_time_ms": 60.0, "pcs.merkle.device_time_ms": 480.0, "commit.device_time_ms": 140.0,
         "whir.device_time_ms": 440.0}

# the leaf's NTT launches a proof (A′ at (2, 2^27), the chunk iDFT, a WHIR
# codeword) beside a Merkle launch and a sponge launch, which the share leaves out
LAUNCHES = {("ntt_recursive", (2, 1 << 27)): 1, ("ntt", (1 << 21, 16)): 2, ("ntt", (4, 1 << 26)): 1,
            ("hash_cols", (2, 1 << 27)): 1, ("compress_cols", (8, 1 << 27)): 4, ("duplex", (16,)): 400}
NTT_LEAST = (y.bound(y.ntt_work((2, 1 << 27)))[0] + 2 * y.bound(y.ntt_work((1 << 21, 16)))[0]
             + y.bound(y.ntt_work((4, 1 << 26)))[0])
DEVICE = [
    ("void (anonymous namespace)::ntt_pass1_kernel<true>(long const*, unsigned int*)", 0, 3_000_000),
    ("void (anonymous namespace)::ntt_pass2_kernel<true>(unsigned int const*, long*)", 3_000_000, 7_000_000),
    ("void (anonymous namespace)::ntt_rows_kernel(long const*, long*, long long, int)", 7_000_000, 8_000_000),
    ("void (anonymous namespace)::hash_cols_kernel(long const*)", 8_000_000, 48_000_000),
    ("void (anonymous namespace)::compress_kernel(long*)", 48_000_000, 68_000_000),
    ("void (anonymous namespace)::duplex_kernel(long*)", 68_000_000, 69_000_000),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", 0, 90_000_000),
]


def test_timings_a_proof():
    run = harness.Run(proofs=4, window_s=6.2, spans_ms=dict(SPANS))
    assert reader("encode_ms").read(run) == 15.0
    assert reader("merkle_ms").read(run) == 120.0
    # every encode and Merkle build lies inside the commit or WHIR segment
    assert reader("encode_ms").read(run) + reader("merkle_ms").read(run) <= (
        harness.span_ms(run, "commit.device") + harness.span_ms(run, "whir.device"))


def test_ntt_roofline_counts_ntt_launches_and_functions_alone():
    # two proofs traced, each 4 ms of the NTT's functions (8 ms in all)
    run = harness.Run(launches=dict(LAUNCHES), profile=_profile(DEVICE, 100_000_000, 2))
    assert reader("ntt_roofline").read(run) == pytest.approx(100 * NTT_LEAST / 4.0)
    # more Merkle or sponge launches and time move nothing
    more = {**LAUNCHES, ("hash_cols", (2, 1 << 27)): 9, ("duplex", (16,)): 4000}
    busier = DEVICE + [("void (anonymous namespace)::compress_kernel(long*)", 69_000_000, 99_000_000)]
    assert reader("ntt_roofline").read(harness.Run(launches=more, profile=_profile(busier, 100_000_000, 2))) == (
        pytest.approx(100 * NTT_LEAST / 4.0))
    # the leaf's share is below its bound's 100%
    assert 0 < reader("ntt_roofline").read(run) <= 100


@pytest.mark.parametrize("name", ["encode_ms", "merkle_ms", "ntt_roofline"])
def test_readers_read_nothing_the_run_did_not_see(name):
    # a parent's run: the segments' timings, no encode or Merkle timing
    parent = harness.Run(proofs=4, window_s=6.2, spans_ms={"commit.device_time_ms": 140.0,
                                                           "whir.device_time_ms": 440.0})
    assert reader(name).read(parent) is None
    assert reader(name).read(harness.Run()) is None
    module = reader(name)
    assert (module.LAYER, module.SOURCE, module.MOVES) == (
        "kernels", "device_trace" if name == "ntt_roofline" else "program_span", "prove_s")
    assert module.UNIT == ("%" if name == "ntt_roofline" else "ms/proof")


def test_ntt_roofline_reads_nothing_without_ntt_time_or_launches():
    share = reader("ntt_roofline").read
    no_ntt = [e for e in DEVICE if "ntt_" not in e[0]]
    assert share(harness.Run(launches=dict(LAUNCHES), profile=_profile(no_ntt, 100_000_000, 2))) is None
    merkle_only = {k: n for k, n in LAUNCHES.items() if not k[0].startswith("ntt")}
    assert share(harness.Run(launches=merkle_only, profile=_profile(DEVICE, 100_000_000, 2))) is None
    assert share(harness.Run(profile=_profile(DEVICE, 100_000_000, 2))) is None
