"""Batched NTT over BabyBear on torch tensors: the wrapper of kernels A and
A′, their plain PyTorch version, the plain four-step split, a model of the
kernel's two four-step passes that checks their index algebra, and the
transforms built on them.

Peer of ``swirl/prover/ntt.py`` (:76-192). ``ntt(x)[i] = poly(w^i)`` with
``w = two_adic_generator(log N)``, natural order in and out, along the last
axis (or the second to last for EF4 arrays ``(..., N, 4)``, which run as
four base planes). ``ntt(inverse=True)`` is unscaled; :func:`intt` applies
1/N.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels as K
from ..fields import field as F
from ..fields.babybear import P, TWO_ADICITY, two_adic_generator

# BabyBear's two-adicity: the longest transform that exists. The TPU code's
# ceiling of 2^28 (ntt_pallas.py:60) has no 2^28-th root of unity to use.
MAX_LOG_N = TWO_ADICITY
SMALL_LOG_MAX = 13  # ntt.cu: one shared-memory pass up to 2^13 points, four-step above
RECURSIVE_LOG_N = 26  # above this the TPU recursed (A′); ntt.cu runs the same two passes


def _root(log_n: int, inverse: bool) -> int:
    w = two_adic_generator(log_n)
    return pow(w, P - 2, P) if inverse else w


def _split(log_n: int):
    """ntt.cu's split N = n1 * n2: (log n1, log n2)."""
    if log_n <= SMALL_LOG_MAX:
        return 0, log_n
    return log_n // 2, log_n - log_n // 2


def _twiddle_tables(log_n: int, log_n1: int, inverse: bool, device: str):
    """The two-level twiddle table of an N = n1 * n2 split, canonical:
    hi[e] = w^(n1*e) for e < n2 and lo[e] = w^e for e < n1, so that
    w^e = hi[e >> log n1] * lo[e & (n1 - 1)] for every e < N."""
    w = _root(log_n, inverse)
    hi = F.powers(pow(w, 1 << log_n1, P), 1 << (log_n - log_n1), device)
    lo = F.powers(w, 1 << log_n1, device)
    return hi, lo


@lru_cache(maxsize=None)
def _kernel_table(log_n: int, inverse: bool, device: str):
    """hi then lo of ntt.cu's split, in Montgomery form (uint32 values in
    int32 storage): n2 + n1 entries, at most 2^14 + 2^13."""
    hi, lo = _twiddle_tables(log_n, _split(log_n)[0], inverse, device)
    return ((torch.cat([hi, lo]) * ((1 << 32) % P)) % P).to(torch.int32)


@lru_cache(maxsize=None)
def _plain_twiddles(log_n: int, inverse: bool, device: str):
    """Per-stage DIF twiddles: stage s (half-block h = N >> (s+1)) uses w_2h^j."""
    w = _root(log_n, inverse)
    return [F.powers(pow(w, 1 << s, P), 1 << (log_n - 1 - s), device) for s in range(log_n)]


@lru_cache(maxsize=None)
def _bitrev(log_n: int, device: str):
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_plain(x, inverse: bool = False):
    """(batch, N) -> (batch, N): decimation in frequency with contiguous-block
    butterflies, then one bit-reversal gather."""
    batch, n = x.shape
    log_n = n.bit_length() - 1
    dev = str(x.device)
    for s, tw in enumerate(_plain_twiddles(log_n, inverse, dev)):
        h = n >> (s + 1)
        v = x.reshape(batch, n // (2 * h), 2, h)
        a, b = v[:, :, 0], v[:, :, 1]
        x = torch.stack([F.add(a, b), F.mul(F.sub(a, b), tw)], dim=2).reshape(batch, n)
    return x[:, _bitrev(log_n, dev)]


def ntt_four_step_plain(x, log_n1: int, inverse: bool = False):
    """(batch, N) -> (batch, N) by the four-step split that ntt.cu runs:
    n1-point sub-NTTs over j1 of the (n1, n2) view, the w^(j2*k1) twiddle
    from the two-level table, n2-point sub-NTTs over j2, and a transpose
    to natural order X[k1 + n1*k2]; equal to :func:`ntt_plain` for every
    split. :func:`ntt_two_pass_model` follows the kernel's own blocks."""
    batch, n = x.shape
    log_n = n.bit_length() - 1
    n1, n2 = 1 << log_n1, n >> log_n1
    a = x.reshape(batch, n1, n2).transpose(1, 2).reshape(batch * n2, n1)
    a = ntt_plain(a, inverse).reshape(batch, n2, n1)  # [j2, k1]
    hi, lo = _twiddle_tables(log_n, log_n1, inverse, str(x.device))
    e = torch.arange(n2, device=x.device)[:, None] * torch.arange(n1, device=x.device)
    a = F.mul(a, F.mul(hi[e >> log_n1], lo[e & (n1 - 1)]))
    a = a.transpose(1, 2).reshape(batch * n1, n2)  # [k1, j2]
    a = ntt_plain(a, inverse).reshape(batch, n1, n2)  # [k1, k2]
    return a.transpose(1, 2).reshape(batch, n)


# ntt.cu's four-step passes: clusters of CLUSTER blocks of 512 threads, each
# block holding a strip of columns in shared memory (C in pass 1, 2 in pass 2)
FS_THREADS = 512
STRIP_LOG_WORDS = 14  # pass 1 from 2^11 points up; 2 columns below
PASS2_COLS = 2
CLUSTER = 2  # blocks a cluster: they load and store whole 32-byte sectors together
WARP = 32


def strip_widths(log_n: int):
    """(C, R): the columns a block of ntt.cu's first and second pass holds."""
    l1 = _split(log_n)[0]
    return 1 << (STRIP_LOG_WORDS - l1 if l1 >= 11 else 1), PASS2_COLS


def swizzle(f, log_n: int, log_cols: int):
    """ntt.cu's shared-memory address of flat strip index f (column
    c * 2^log_n + point i) in a strip of 2^log_cols columns: bits 0-4 of f
    are XORed with the bits of i from max(7, log_n - 5) up, with 31 times
    bit 5 of f, 21 times bit 6, and with (c >> 1) ^ (c << max(2, 5 -
    log_cols)) mod 32."""
    hs = max(7, log_n - 5)
    c = f >> log_n
    t = ((f >> hs) & (((1 << log_n) - 1) >> hs) & 31) ^ (((f >> 5) & 1) * 31) ^ (((f >> 6) & 1) * 21)
    return f ^ t ^ (((c >> 1) ^ (c << max(2, 5 - log_cols))) & 31)


def bank_conflicts(addr, group=None) -> int:
    """The most distinct shared-memory words that one warp access places
    in one of the 32 banks: ``addr`` holds word addresses, one access a run
    of 32 lanes, or one access each value of ``group`` where given. 1 is
    conflict-free; lanes on one word share it by broadcast."""
    addr = addr.reshape(-1)
    group = torch.arange(addr.numel()) // WARP if group is None else group.reshape(-1)
    span = int(addr.max()) + 1
    words = torch.unique(group * span + addr)  # distinct (access, word)
    banks = (words // span) * WARP + (words % span) % WARP
    return int(torch.unique(banks, return_counts=True)[1].max())


def _assert_conflict_free(addr, what: str, group=None):
    degree = bank_conflicts(addr, group)
    if degree != 1:
        raise AssertionError(f"{what}: {degree}-way bank conflict")


def _assert_permutation(idx, n: int, what: str):
    if idx.numel() != n or not torch.equal(torch.sort(idx.reshape(-1)).values, torch.arange(n)):
        raise AssertionError(f"{what}: not every index of [0, {n}) exactly once")


def _assert_once(bases, local, total: int, what: str):
    """Every global index base + offset (a base per block, the same
    offsets in every block) is touched exactly once over [0, total)."""
    if bases.numel() * local.numel() != total:
        raise AssertionError(f"{what}: {bases.numel()} x {local.numel()} writes for {total} indices")
    counts = torch.zeros(total, dtype=torch.uint8)
    step = max(1, (1 << 22) // local.numel())
    for i in range(0, bases.numel(), step):
        idx = (bases[i : i + step, None] + local[None, :]).reshape(-1)
        if int(idx.min()) < 0 or int(idx.max()) >= total:
            raise AssertionError(f"{what}: an index outside [0, {total})")
        counts[idx] += 1  # a repeat within one chunk leaves another index at 0
    if not bool((counts == 1).all()):
        raise AssertionError(f"{what}: an index written twice or never")


def ins2(q, h: int):
    """q with two zero bits inserted at bit log2(h): a quartet's first point."""
    return ((q & ~(h - 1)) << 2) | (q & (h - 1))


def _xor_split(base, offsets, l: int, lc: int):
    """swizzle(base + o) for each offset o as the kernel forms it,
    swizzle(base) ^ swizzle(o), after asserting that base and o share no
    bit (the swizzle is linear over GF(2)) and that both forms agree."""
    out = []
    for o in offsets:
        if bool((base & o).any()):
            raise AssertionError("an offset shares a bit with its base")
        a = swizzle(base, l, lc) ^ swizzle(torch.as_tensor(o), l, lc)
        if not torch.equal(a, swizzle(base + o, l, lc)):
            raise AssertionError("the swizzle of base + offset is not the XOR of the parts")
        out.append(a)
    return out


def _check_round(l: int, lg: int, addrs, tws, words: int):
    """One round of stages: every word read and written by one thread,
    each access conflict-free. Returns (addresses, table indices)."""
    what = f"pass of 2^{l} points, stage {lg}"
    _assert_permutation(torch.cat(addrs), words, what)
    for m, a in enumerate(addrs):
        _assert_conflict_free(a, f"{what}: point {m}")
    for m, (a, _) in enumerate(tws):
        _assert_conflict_free(a, f"{what}: twiddle {m}")
    return addrs, [t for _, t in tws]


def _cluster_load(l: int, log_cols: int, what: str):
    """The loads of a cluster of CLUSTER blocks of 2^log_cols columns of
    2^l points: block ``rank`` reads rows [rank * 2^l / CLUSTER, ...) of
    the cluster's CLUSTER * 2^log_cols columns, 16 bytes a lane, the lanes
    of a row side by side (pass 1: two int64 columns a lane; pass 2: four
    u32, two blocks' columns), and stores point j of column c of block q at
    swizzle(c * 2^l + brev(j)) of q's strip. Returns, for each rank, for
    each value of a lane, (q, address). Asserts that every strip word is
    stored once and that the lanes storing into one strip in one
    instruction are conflict-free (strips wider than 2 columns of 2^8 to
    2^10 points are not: the rows' bits and the column term share bank
    bits, which is why the kernel holds 2 there)."""
    n, cols = 1 << l, 1 << log_cols
    rev = _bitrev(l, "cpu")
    per_lane = 2 if what == "pass 1" else 4
    lanes_a_row = CLUSTER * cols // per_lane
    v = torch.arange((n // CLUSTER) * lanes_a_row)
    row, w = v // lanes_a_row, v % lanes_a_row
    stored = [[] for _ in range(CLUSTER)]
    plan = []
    for rank in range(CLUSTER):
        i = rev[rank * (n // CLUSTER) + row]
        values = []
        for k in range(per_lane):
            pc = w * per_lane + k  # the cluster's column
            q, c = pc >> log_cols, pc & (cols - 1)
            addr = _xor_split(i, [c * n], l, log_cols)[0]
            # the lanes of one warp that store into one block's strip
            _assert_conflict_free(addr, f"{what} load, rank {rank}, value {k}", (v // WARP) * CLUSTER + q)
            for qq in range(CLUSTER):
                stored[qq].append(addr[q == qq])
            values.append((q, addr))
        plan.append(values)
    for qq in range(CLUSTER):
        _assert_permutation(torch.cat(stored[qq]), cols * n, f"{what} load into block {qq}")
    return plan


def _pass_plan(l: int, log_cols: int, hi_log: int, what: str):
    """The shared-memory side of one four-step pass of ntt.cu: 2^log_cols
    columns of 2^l points a block, loaded by the cluster in bit-reversed
    order (:func:`_cluster_load`), run through l DIT stages (one radix-2
    stage when l is odd, then radix-4 rounds of two stages), read in
    natural order. Asserts that each warp access is free of bank conflicts
    and that every shared word is written once a phase. Returns (load,
    stages, store):
    - stages: (addresses of the 2 or 4 points, table indices) a round;
    - store: in pass 1, for thread g, (address, column c, point k1): the
      tile order of A_T, k1 = 4 (g >> (log_cols + 2)) + (g & 3) and
      c = (g >> 2) mod 2^log_cols; in pass 2, for each (rank, e), the
      addresses block rank reads for points [rank * 2^l / CLUSTER, ...),
      CLUSTER lanes a row, lane v reading column e of block (v mod
      CLUSTER)'s strip.
    The stage twiddles are hi[pos << (hi_log - lg)], hi of 2^hi_log."""
    n, cols = 1 << l, 1 << log_cols
    words = cols << l
    load = _cluster_load(l, log_cols, what)
    tw_base = words
    stages = []
    lg = 1
    if l % 2:  # one radix-2 stage of half 1 (twiddle 1): thread k, flat 2k and 2k + 1
        k = torch.arange(words // 2)
        t = k & (FS_THREADS - 1)  # the kernel: swizzle(2 k0) ^ swizzle(2 t) for k = k0 + t
        _xor_split(2 * (k - t), [2 * t], l, log_cols)
        stages.append(_check_round(l, lg, _xor_split(2 * k, [0, 1], l, log_cols), [], words))
        lg = 2
    q = torch.arange(words // 4)
    while lg < l:  # stages lg and lg + 1 on quartets: thread q, flat i0 + m h, m < 4
        h = 1 << (lg - 1)
        pos = q & (h - 1)
        i0 = ((q - pos) << 2) | pos
        # the kernel: swizzle(ins(q0)) ^ swizzle(ins(t)) for q = q0 + t, t < FS_THREADS
        t = q & (FS_THREADS - 1)
        if not torch.equal(_xor_split(i0 - ins2(t, h), [ins2(t, h)], l, log_cols)[0], swizzle(i0, l, log_cols)):
            raise AssertionError("a quartet's swizzle is not its thread part XOR its iteration part")
        tws = [(tw_base + h + pos, pos << (hi_log - lg)),  # w_2h^pos
               (tw_base + 2 * h + pos, pos << (hi_log - lg - 1)),  # w_4h^pos
               (tw_base + 3 * h + pos, (pos + h) << (hi_log - lg - 1))]  # w_4h^(pos + h)
        stages.append(_check_round(l, lg, _xor_split(i0, [m * h for m in range(4)], l, log_cols), tws, words))
        lg += 2
    # the stage-major copy of the twiddles: thread t - 1 writes word t, 1 <= t < n
    _assert_conflict_free(tw_base + 1 + torch.arange(n), f"{what}: twiddle copy")
    if what == "pass 1":
        g = torch.arange(words)
        c, k1 = (g >> 2) & (cols - 1), ((g >> (log_cols + 2)) << 2) | (g & 3)
        addr = _xor_split(k1, [c * n], l, log_cols)[0]
        _assert_conflict_free(addr, f"{what}: store")
        return load, stages, (addr, c, k1)
    # pass 2: block rank writes rows [rank * n / CLUSTER, ...) of the
    # cluster's columns; lane v reads column e of block v mod CLUSTER's strip
    v = torch.arange(n)
    q = v % CLUSTER
    store = []
    for rank in range(CLUSTER):
        for e in (0, 1):
            addr = _xor_split(rank * (n // CLUSTER) + v // CLUSTER, [e * n], l, log_cols)[0]
            # the lanes of a warp that read one block's strip
            _assert_conflict_free(addr, f"{what}: store, rank {rank}, {e}", (v // WARP) * CLUSTER + q)
            store.append(addr)
    return load, stages, store


def two_pass_plan(log_n: int, log_n1: int, strip1: int, strip2: int = PASS2_COLS, batch: int = 1):
    """The kernel's block decomposition of a (batch, 2^log_n) four-step NTT
    with n1 = 2^log_n1 <= n2, ``strip1`` columns a block in pass 1 and
    ``strip2`` (the kernel's 2) in pass 2, CLUSTER blocks a cluster, checked on
    index arrays alone: conflict-free shared memory in every phase, every
    input, scratch and output index touched exactly once, and the 16-byte
    vector accesses aligned. The scratch A_T is tiled: A_T[b, t, j2, r]
    holds k1 = 4 t + r, so that a pass-2 cluster's 4 columns are one
    contiguous run. Returns the plans of both passes and the global
    offsets (per-block bases, in-block offsets) of their loads and stores."""
    l1, l2 = log_n1, log_n - log_n1
    lc = strip1.bit_length() - 1
    if strip2 != PASS2_COLS or not 2 <= strip1 <= WARP or (1 << lc) != strip1:
        raise ValueError(f"strips of {strip1} and {strip2} columns: pass 1 takes a power of two "
                         f"from 2 (a 16-byte vector) to 32, pass 2 {PASS2_COLS}")
    if not 6 < l1 <= l2 or CLUSTER * strip1 > (1 << l2) or CLUSTER * strip2 > (1 << l1):
        raise ValueError(f"no two-pass split of 2^{log_n} at 2^{l1} with strips {strip1}, {strip2}")
    n1, n2, total = 1 << l1, 1 << l2, batch << log_n
    p1 = _pass_plan(l1, lc, l2, "pass 1")
    p2 = _pass_plan(l2, 1, l2, "pass 2")
    b = torch.arange(batch)[:, None] * (1 << log_n)
    # pass 1: block (b, t) holds columns j2 = t*C + c and loads rows
    # [rank * n1/CLUSTER, ...) of its cluster's CLUSTER * C columns; thread
    # g writes A_T[b, k1 >> 2, j2, k1 & 3]: runs of 4C words a tile
    t = torch.arange(n2 // strip1)
    rank = t % CLUSTER
    lanes_a_row = CLUSTER * strip1 // 2
    v = torch.arange((n1 // CLUSTER) * lanes_a_row)
    in1 = ((b + (t - rank) * strip1 + rank * (n1 // CLUSTER) * n2).reshape(-1),
           ((v // lanes_a_row) * n2 + 2 * (v % lanes_a_row))[:, None] + torch.arange(2)[None, :])
    g = torch.arange(strip1 * n1)
    out1 = (b + 4 * strip1 * t).reshape(-1), ((g >> (lc + 2)) << (l2 + 2)) | (g & (4 * strip1 - 1))
    # pass 2: block (b, t) holds columns k1 = 2t + r and loads rows
    # [rank * n2/CLUSTER, ...) of its cluster's tile of 2 * CLUSTER columns,
    # 16 bytes (four u32, one row of the tile) a lane; it writes the same
    # rows of out, 16 bytes a lane
    t = torch.arange(n1 // 2)
    rank = t % CLUSTER
    k1_0 = (t - rank) * 2
    in2 = ((b + (k1_0 >> 2) * (4 * n2) + rank * (n2 // CLUSTER) * 4).reshape(-1),
           (4 * torch.arange(n2 // CLUSTER))[:, None] + torch.arange(4)[None, :])
    v = torch.arange(n2)
    out2 = ((b + k1_0 + rank * (n2 // CLUSTER) * n1).reshape(-1),
            ((v // CLUSTER) * n1 + 2 * (v % CLUSTER))[:, None] + torch.arange(2)[None, :])
    _assert_once(in1[0], in1[1].reshape(-1), total, "pass 1 load")
    _assert_once(out1[0], out1[1], total, "pass 1 store")
    _assert_once(in2[0], in2[1].reshape(-1), total, "pass 2 load")
    _assert_once(out2[0], out2[1].reshape(-1), total, "pass 2 store")
    for bases, local, vec, what in ((in1[0], in1[1][:, 0], 2, "pass 1 longlong2 load"),
                                    (in2[0], in2[1][:, 0], 4, "pass 2 uint4 load"),
                                    (out2[0], out2[1][:, 0], 2, "pass 2 longlong2 store")):
        if bool((bases % vec != 0).any()) or bool((local % vec != 0).any()):
            raise AssertionError(f"{what}: not aligned to its vector")
    return p1, p2, (in1, out1, in2, out2)


def _run_stages(s, stages, table):
    for a, t in stages:
        if len(a) == 2:  # half 1: the twiddle is 1
            u, v = s[:, a[0]], s[:, a[1]]
            s[:, a[0]], s[:, a[1]] = F.add(u, v), F.sub(u, v)
            continue
        t1, t2, t3 = (table[i] for i in t)
        x0, x1, x2, x3 = s[:, a[0]], F.mul(s[:, a[1]], t1), s[:, a[2]], F.mul(s[:, a[3]], t1)
        y0, y1, y2, y3 = F.add(x0, x1), F.sub(x0, x1), F.add(x2, x3), F.sub(x2, x3)
        u2, u3 = F.mul(y2, t2), F.mul(y3, t3)
        s[:, a[0]], s[:, a[2]] = F.add(y0, u2), F.sub(y0, u2)
        s[:, a[1]], s[:, a[3]] = F.add(y1, u3), F.sub(y1, u3)


def _load_walk(src, load, base, local, words: int):
    """Each block's strip after the cluster loads of :func:`_cluster_load`:
    lane v of block ``rank`` reads src[base + local[v]] into the strip of
    block cluster + q at each value's address."""
    s = torch.empty(base.numel(), words, dtype=torch.int64)
    blocks = torch.arange(base.numel())
    for rank, values in enumerate(load):
        mine = blocks[blocks % CLUSTER == rank]
        vals = src[base[mine][:, None, None] + local[None, :, :]]  # [block, lane, value]
        for k, (q, addr) in enumerate(values):
            s[(mine - rank)[:, None] + q[None, :], addr[None, :].expand(mine.numel(), -1)] = vals[:, :, k]
    return s


def ntt_two_pass_model(x, log_n1: int, strip1: int, strip2: int = PASS2_COLS, inverse: bool = False):
    """(batch, N) -> (batch, N) as ntt.cu's two four-step passes compute it,
    block by block through shared memory at the kernel's addresses, after
    :func:`two_pass_plan` has checked them. Pass 1: a cluster loads CLUSTER
    * ``strip1`` adjacent columns j2 of the (n1, n2) view into its blocks;
    a block runs its columns' n1-point NTTs, multiplies by w^(j2*k1) and
    writes the tiled A_T[b, k1 >> 2, j2, k1 & 3]. Pass 2: a cluster loads
    2 * CLUSTER adjacent columns k1 of A_T (one tile), a block runs its 2
    columns' n2-point NTTs, and each block writes 1/CLUSTER of the rows of
    out[b, k2*n1 + k1] for all the cluster's columns, reading every
    block's strip."""
    batch, n = x.shape
    log_n = n.bit_length() - 1
    n1, n2 = 1 << log_n1, n >> log_n1
    (load1, st1, store1), (load2, st2, store2), (in1, out1, in2, out2) = two_pass_plan(
        log_n, log_n1, strip1, strip2, batch)
    hi, lo = (t.cpu() for t in _twiddle_tables(log_n, log_n1, inverse, "cpu"))
    flat = x.reshape(-1).cpu()
    # pass 1
    s = _load_walk(flat, load1, in1[0], in1[1], strip1 * n1)
    _run_stages(s, st1, hi)
    addr, c, k1 = store1
    j2_0 = strip1 * (torch.arange(out1[0].numel()) % (n2 // strip1))
    e = (j2_0[:, None] + c[None, :]) * k1[None, :]
    a_t = torch.empty_like(flat)
    a_t[out1[0][:, None] + out1[1][None, :]] = F.mul(s[:, addr], F.mul(hi[e >> log_n1], lo[e & (n1 - 1)]))
    # pass 2
    s = _load_walk(a_t, load2, in2[0], in2[1], 2 * n2)
    _run_stages(s, st2, hi)
    out = torch.empty_like(flat)
    blocks = torch.arange(in2[0].numel())
    q = torch.arange(n2) % CLUSTER
    for i, addr in enumerate(store2):
        rank, e = divmod(i, 2)
        mine = blocks[blocks % CLUSTER == rank]
        src = (mine - rank)[:, None] + q[None, :]
        out[out2[0][mine][:, None] + out2[1][:, e][None, :]] = s[src, addr[None, :].expand_as(src)]
    return out.reshape(batch, n).to(x.device)


def kernel_for(log_n: int):
    """The launch counter a CUDA transform of 2^log_n points adds to."""
    return K.NTT_RECURSIVE if log_n > RECURSIVE_LOG_N else K.NTT


def _ntt_kernel(x, inverse: bool):
    K.require(x, 2, "ntt")
    batch, n = x.shape
    log_n = n.bit_length() - 1
    table = _kernel_table(log_n, inverse, str(x.device))
    if x.data_ptr() % 16:  # the four-step passes read rows as 16-byte vectors
        x = x.clone()
    out = torch.empty_like(x)
    # four-step: one uint32 scratch, pass 1's output A_T and pass 2's input
    scratch = torch.empty(batch * n, dtype=torch.int32, device=x.device) if log_n > SMALL_LOG_MAX else None
    K.LIB.launch(
        kernel_for(log_n), "swirl_ntt", x, x.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), batch, log_n, table.data_ptr(),
    )
    return out


def ntt_rows(x, inverse: bool = False):
    """Kernels A and A′: (batch, N) base-field rows -> their DFTs."""
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > MAX_LOG_N:
        raise ValueError(f"ntt: length {n} is not a power of two <= 2^{MAX_LOG_N}")
    if n == 1 or x.shape[0] == 0:
        return x.clone()
    if x.is_cuda:
        return _ntt_kernel(x, inverse)
    return ntt_plain(x, inverse)


def ntt(x, inverse: bool = False, ext: bool = False):
    """DFT along the data axis (-1, or -2 for EF4 arrays), natural order."""
    if ext:
        planes = x.movedim(-1, -2)  # (..., 4, N)
        out = ntt(planes.contiguous(), inverse)
        return out.movedim(-2, -1).contiguous()
    shape = x.shape
    return ntt_rows(x.reshape(-1, shape[-1]).contiguous(), inverse).reshape(shape)


def intt(x, ext: bool = False):
    """Inverse DFT with the 1/N scale."""
    n = x.shape[-2 if ext else -1]
    if n == 1:
        return x
    return F.mul(ntt(x, inverse=True, ext=ext), pow(n, P - 2, P))


def coset_ntt(coeffs, shift: int, ext: bool = False):
    """Evaluate on the coset shift * <w>: scale by shift^i, then NTT."""
    n = coeffs.shape[-2 if ext else -1]
    pows = F.powers(shift, n, coeffs.device)
    return ntt(F.mul(coeffs, pows[:, None] if ext else pows), ext=ext)


def _subset_transform(x, log_k: int, ext: bool, op):
    if ext:
        return _subset_transform(x.movedim(-1, -2), log_k, False, op).movedim(-2, -1).contiguous()
    shape = x.shape
    n = shape[-1]
    for b in range(log_k):
        v = x.reshape(shape[:-1] + (n >> (b + 1), 2, 1 << b))
        lo, hi = v[..., 0, :], v[..., 1, :]
        x = torch.stack([lo, op(hi, lo)], dim=-2).reshape(shape)
    return x


def zeta_transform(x, log_k: int, ext: bool = False):
    """Subset zeta over the low log_k index bits: x[i | 2^b] += x[i]."""
    return _subset_transform(x, log_k, ext, F.add)


def mobius_transform(x, log_k: int, ext: bool = False):
    """Inverse of :func:`zeta_transform`: x[i | 2^b] -= x[i]."""
    return _subset_transform(x, log_k, ext, F.sub)
