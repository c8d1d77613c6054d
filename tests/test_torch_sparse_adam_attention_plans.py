"""K12's and K6's host-side plans and split arithmetic, on the CPU.

K12 (kernels/sparse_adam.py, csrc/sparse_adam.cu) sorts every table's ids
as one key space (the table's key offset plus the id; a dropped id takes
the key one past every table) by a stable LSD radix sort, a CTA per
2,048 pairs ranking by digit in shared memory and placing its pairs from
slots a scan launch gives each (tile, digit); then a warp per 32 sorted pairs sums each id's rows
in position order, and an id whose rows run into a third chunk is summed
a chunk at a time, its partials in contiguous runs, the runs in order.
K6 (kernels/attention.py, csrc/attention_backward.cu) runs a
thread-block cluster of C CTAs per row, each holding a chunk of the
row's contexts, and adds the chunks' sums of w fs and their da shares
in rank order, then the rows' da in 32 runs. The CUDA kernels run only
on the card; here their plans (`sparse_adam.plan`, `attention.
backward_plan`) are checked over every width and size the wrappers take,
and their arithmetic, emulated in plain PyTorch
(`sparse_adam.radix_destinations`, `sparse_adam.segment_sums`,
`attention.split_backward`), is held against the JAX package on the same
seeded numpy inputs: `code2vec_tpu/training/sparse_adam.py`
`combine_duplicate_rows` and `sparse_adam_rows`, and `jax.vjp` of
`code2vec_tpu/ops/attention.py` `masked_single_query_attention`.

Tolerances, ROADMAP's parity bar: f32 rtol 1e-5, atol 1e-6 (sums taken in
another order); the Adam update rtol 1e-6, atol 1e-9 on tables and nu, a
bf16 mu equal or one bf16 step apart (tests/test_torch_sparse.py's: the
same elementwise chain); bf16 outputs atol 2e-2, rtol 1e-2 (one bf16 step
where an f32 sum's order flips a rounding). The sort's order is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu.ops.attention import masked_single_query_attention
from code2vec_tpu.training import sparse_adam as jsparse
from code2vec_tpu_torch.kernels import attention, sparse_adam
from code2vec_tpu_torch.kernels.adam import AdamHyper
from code2vec_tpu_torch.ops.attention import (
    masked_single_query_attention as torch_attention,
    masked_single_query_attention_backward,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
ADAM = dict(rtol=1e-6, atol=1e-9)
BF16 = dict(rtol=1e-2, atol=2e-2)
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
SMS = 132           # an H100's SMs
SMEM = 232448       # the shared memory an H100 block may opt into
V_TOKEN, V_PATH = 1301137, 911418   # the flagship's tables
N_STEP = 614400     # ids of both tables in one flagship step


# ------------------------------------------------------------ K12's plan

N_SWEEP = sorted(set(list(range(1, 4200, 97)) + [
    31, 32, 33, 63, 64, 65, 2047, 2048, 2049, 4095, 4096, 4097, 204800,
    409600, 409601, N_STEP]))


@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_sparse_adam_plan_every_width_and_size(d):
    """Every width the kernel takes and every n from 1 to both tables'
    614,400 ids, over the flagship's key spaces (one table, both) and
    small ones: the digit passes cover every key's bits with 8- to
    11-bit digits (two passes for both tables), the tiles and chunks
    cover n with less than one of padding, and the scratch holds each
    part (keys and positions twice, every pass's tile counts and one
    pass's slots, the digit counts, the counters, the long list and two
    partial rows a chunk) and grows with n."""
    for keys in (1, 300, 70000, V_TOKEN, V_TOKEN + V_PATH):
        prev = 0
        for n in N_SWEEP:
            p = sparse_adam.plan(n, keys, d)
            assert sparse_adam.MIN_DIGIT_BITS <= p.digit_bits <= \
                sparse_adam.MAX_DIGIT_BITS
            assert p.passes * p.digit_bits >= keys.bit_length()
            assert (p.passes - 1) * p.digit_bits < max(keys.bit_length(),
                                                       p.digit_bits)
            assert p.bins == 1 << p.digit_bits
            assert 0 <= p.tiles * sparse_adam.TILE - n < sparse_adam.TILE
            assert 0 <= p.chunks * sparse_adam.CHUNK - n < sparse_adam.CHUNK
            parts = (4 * 4 * n + 4 * p.passes * p.bins
                     + 4 * sparse_adam.COUNTERS
                     + 4 * (p.passes + 1) * p.tiles * p.bins
                     + 4 * p.chunks + 2 * 4 * p.chunks * d)
            assert parts <= p.scratch_bytes < parts + 8 * 256 + 64
            assert p.scratch_bytes >= prev
            prev = p.scratch_bytes
    # both flagship tables: two passes of 11 bits; smaller key spaces
    # take one or two passes of 8 to 11 bits
    for keys, shape in ((V_TOKEN + V_PATH, (2, 11)), (V_TOKEN, (2, 11)),
                        (255, (1, 8)), (1500, (1, 11)), (70000, (2, 9))):
        assert sparse_adam.plan(N_STEP, keys, d)[:2] == shape


def _keys(rng, dist, n, v):
    """n ids over [0, v) as the sort's keys (out of range -> v)."""
    if dist == "zipf":
        p = np.arange(1, v + 1, dtype=np.float64) ** -1.07
        ids = rng.choice(v, size=n, p=p / p.sum())
    elif dist == "same":
        ids = np.full(n, rng.integers(0, v))
    else:
        ids = rng.integers(0, v, n)
    if dist == "out_of_range":
        ids[rng.random(n) < 0.25] = v
    return torch.from_numpy(ids.astype(np.int64))


def _radix_order(keys, keyspace):
    p = sparse_adam.plan(keys.shape[0], keyspace, 128)
    k, order = keys.clone(), torch.arange(keys.shape[0])
    for ps in range(p.passes):
        dest = sparse_adam.radix_destinations(k, ps * p.digit_bits, p.bins)
        assert torch.equal(torch.sort(dest).values,
                           torch.arange(keys.shape[0]))
        nk, no = torch.empty_like(k), torch.empty_like(order)
        nk[dest], no[dest] = k, order
        k, order = nk, no
    return k, order


@pytest.mark.parametrize("n", [1, 33, 2047, 2049, 20000])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "same",
                                  "out_of_range"])
@pytest.mark.parametrize("v", [V_TOKEN + V_PATH, 70000, 300])
def test_radix_passes_are_a_stable_sort(n, dist, v):
    """The kernel's digit passes (the scan's (tile, digit) slots, warp
    offsets, ranks within a warp) place every pair once and leave the
    keys in stable order, across tile and warp boundaries, with the
    dropped key last: two passes of 11 bits (both flagship tables), two
    of 9, one of 9."""
    rng = np.random.default_rng(n + len(dist))
    keys = _keys(rng, dist, n, v)
    k, order = _radix_order(keys, v)
    assert torch.equal(order, torch.argsort(keys, stable=True))
    assert torch.equal(k, keys[order])


def _jax_combined(ids, grads):
    ids_s, g_u, first = jsparse.combine_duplicate_rows(
        jnp.asarray(ids), jnp.asarray(grads))
    ids_s, g_u, first = map(np.asarray, (ids_s, g_u, first))
    return {int(i): g_u[j] for j, i in enumerate(ids_s) if first[j]}


@pytest.mark.parametrize("n", [1, 31, 32, 64, 65, 96, 200, 3000])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "same"])
def test_segment_sums_match_combine_duplicate_rows(n, dist):
    """The segment and combine passes' sums (position order within an id
    that ends in its first chunk or the next; a long id a chunk at a time,
    then runs of partials) against the reference's duplicate
    combining, at f32 tolerance; exactly on rows that are bf16 integers
    times 2^-12, whose partial sums are exact in any order."""
    rng = np.random.default_rng(n * 7 + len(dist))
    v = 50
    ids = _keys(rng, dist, n, v).numpy().astype(np.int32)
    grads = rng.standard_normal((n, 8)).astype(np.float32)
    exact = (rng.integers(-127, 128, (n, 8)) * 2.0 ** -12).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    for rows, tol in ((grads, F32), (exact, dict(rtol=0, atol=0))):
        got = sparse_adam.segment_sums(torch.from_numpy(ids[order]).long(),
                                       torch.from_numpy(rows[order]),
                                       dead=v)
        want = _jax_combined(ids, rows)
        assert sorted(got) == sorted(want)
        for key, row in want.items():
            np.testing.assert_allclose(got[key].numpy(), row, **tol)


def _emulated_step(tables, slots, ids_list, grads_list, t):
    """One K12 launch over several tables, in the kernel's terms: the
    combined key space, the radix passes, the segment sums and the
    update, in place on torch tensors."""
    key_base = np.cumsum([0] + [tb.shape[0] for tb in tables])
    dead = int(key_base[-1])
    keys, rows = [], []
    for k, (ids, grads) in enumerate(zip(ids_list, grads_list)):
        ok = (ids >= 0) & (ids < tables[k].shape[0])
        keys.append(torch.where(ok, ids.long() + int(key_base[k]),
                                torch.full_like(ids.long(), dead)))
        rows.append(grads.float())
    keys, rows = torch.cat(keys), torch.cat(rows)
    k_sorted, order = _radix_order(keys, dead)
    sums = sparse_adam.segment_sums(k_sorted, rows[order], dead)
    c = AdamHyper(learning_rate=HYPER["lr"], b1=HYPER["b1"],
                  b2=HYPER["b2"], eps=HYPER["eps"]).scalars(t)
    for key, g in sums.items():
        k = int(np.searchsorted(key_base, key, side="right")) - 1
        u = key - int(key_base[k])
        table, s = tables[k], slots[k]
        m, nu = s["mu"][u].float(), s["nu"][u]
        new_mu = c["b1"] * m + c["one_minus_b1"] * g
        new_nu = c["b2"] * nu + c["one_minus_b2"] * (g * g)
        delta = (c["neg_lr"] * (new_mu / c["b1c"])) / (
            torch.sqrt(new_nu / c["b2c"]) + c["eps"])
        table[u] = table[u] + delta
        dt = s["mu"].dtype
        s["mu"][u] = (m + (new_mu.to(dt).float() - m).to(dt).float()).to(dt)
        s["nu"][u] = nu + (new_nu - nu)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "same",
                                  "out_of_range"])
def test_emulated_sparse_adam_matches_jax_over_steps(mu_dtype, dist):
    """Both tables in one emulated launch (token ids 2n, path ids n, as
    the sparse step gives them), three steps, against the reference's
    sparse_adam_rows per table: touched rows within Adam's tolerance,
    every other row bit-equal to its start. The gradient rows are bf16
    integers times powers of two, so every duplicate sum is exact in any
    order and the two sides update with the same g (the sums' order is
    held at f32 tolerance by the test above). Out-of-range ids lie past
    the table, where the reference drops them too (its scatter wraps a
    negative id onto the last row; no path gives one, and the port drops
    it, as tests/test_torch_kernels_cuda.py checks)."""
    jdt = jnp.bfloat16 if mu_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(len(dist) + len(mu_dtype))
    shapes = ((60, 200), (40, 100))  # (rows, ids) of each table
    d = 8
    tables, slots, jstate, starts = [], [], [], []
    for v, _ in shapes:
        t0 = rng.standard_normal((v, d)).astype(np.float32)
        m0 = (rng.standard_normal((v, d)) * 1e-2).astype(np.float32)
        n0 = (rng.random((v, d)) * 1e-4).astype(np.float32)
        tables.append(torch.from_numpy(t0.copy()))
        slots.append({"mu": torch.from_numpy(m0).to(tdt),
                      "nu": torch.from_numpy(n0.copy())})
        jstate.append((jnp.asarray(t0), jsparse.RowAdamSlots(
            mu=jnp.asarray(m0).astype(jdt), nu=jnp.asarray(n0))))
        starts.append((t0, slots[-1]["mu"].clone(), n0))
    touched = [np.zeros(v, bool) for v, _ in shapes]
    for step in range(3):
        ids_list, grads_list = [], []
        for k, (v, n) in enumerate(shapes):
            ids = _keys(rng, dist, n, v).numpy().astype(np.int32)
            if dist == "out_of_range":  # past the table: dropped
                ids[ids == v] = rng.choice([v, v + 7, 2 ** 31 - 1],
                                           int((ids == v).sum()))
            grads = (rng.integers(-127, 128, (n, d)) * 2.0 ** -12
                     * 2.0 ** rng.integers(-12, 1)).astype(np.float32)
            touched[k][ids[(ids >= 0) & (ids < v)]] = True
            ids_list.append(torch.from_numpy(ids))
            grads_list.append(torch.from_numpy(grads))
            jt, js = jstate[k]
            jstate[k] = jsparse.sparse_adam_rows(
                jt, js, jnp.asarray(ids), jnp.asarray(grads),
                t=jnp.asarray(7 + step, jnp.int32), **HYPER)
        _emulated_step(tables, slots, ids_list, grads_list, 7 + step)
    for k in range(len(shapes)):
        jt, js = jstate[k]
        np.testing.assert_allclose(tables[k].numpy(), np.asarray(jt), **ADAM)
        np.testing.assert_allclose(slots[k]["nu"].numpy(), np.asarray(js.nu),
                                   **ADAM)
        got_mu = slots[k]["mu"].float().numpy()
        want_mu = np.asarray(js.mu.astype(jnp.float32))
        step_mu = (2.0 ** -7 if mu_dtype == "bfloat16" else 1e-6) * \
            np.abs(want_mu) + 1e-12
        assert (np.abs(got_mu - want_mu) <= step_mu).all()
        t0, m0, n0 = starts[k]
        off = ~touched[k]
        np.testing.assert_array_equal(tables[k].numpy()[off], t0[off])
        np.testing.assert_array_equal(slots[k]["nu"].numpy()[off], n0[off])
        assert torch.equal(slots[k]["mu"][torch.from_numpy(off)],
                           m0[torch.from_numpy(off)])


# ------------------------------------------------------------- K6's plan


@pytest.mark.parametrize("d", [8, 128, 384, 512, 1024, 4096])
def test_backward_plan_every_batch_and_length(d):
    """K6's cluster size and chunk for every batch and context count the
    wrapper may see: C in 1-8, C chunks cover the row with less than one
    chunk to spare, a staged chunk fits (else the row is read from device
    memory), C doubles only while B x C falls short of the SMs or a chunk
    takes more than a quarter of the shared memory; the da groups fill
    the CTA without passing it; the smem is the layout's."""
    units = d // 8
    groups = attention.da_groups(d)
    assert groups * min(units, attention.THREADS) <= attention.THREADS
    assert groups == 1 or groups * units > attention.THREADS - units
    for b in (1, 2, 8, 64, 1024, 4096):
        for m in (1, 2, 5, 32, 199, 200, 201, 1000, 60000):
            p = attention.backward_plan(b, m, d, SMEM, SMS)
            assert p.cluster in (1, 2, 4, 8)
            assert p.chunk == -(-m // p.cluster)
            assert 0 <= p.cluster * p.chunk - m < p.cluster
            assert p.smem <= SMEM and p.grid == b * p.cluster
            assert p.staged == (attention.backward_smem_bytes(
                p.chunk, d, True) <= SMEM)
            if p.cluster > 1:
                half = -(-m // (p.cluster // 2))
                assert (b * (p.cluster // 2) < SMS or
                        attention.backward_smem_bytes(half, d, True)
                        > SMEM // 4)
    # the flagship's train and B 64 shapes: four CTAs a row, staged
    for b in (1024, 64):
        assert attention.backward_plan(b, 200, 384, SMEM, SMS)[:3] == \
            (4, 50, True)


def _jax_backward(t, a, mask, dcv):
    """jax.vjp of the reference's attention in (T, a), with the code
    vectors' cotangent and none on the weights."""
    def f(t_, a_):
        return masked_single_query_attention(t_, a_, jnp.asarray(mask))[0]

    _, vjp = jax.vjp(f, jnp.asarray(t).astype(jnp.bfloat16), jnp.asarray(a))
    dt, da = vjp(jnp.asarray(dcv))
    return (np.asarray(dt.astype(jnp.float32)),
            np.asarray(da.astype(jnp.float32)))


@pytest.mark.parametrize("m", [1, 32, 200])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_split_backward_matches_jax_grad(m, cluster):
    """K6's chunked arithmetic (posts of w fs and da shares in rank order,
    da groups, 32 runs of rows) and the plain version against jax.vjp of
    the reference's attention, with an all-masked row and a row with one
    valid context, in bf16 compute; the emulation is within f32 rounding
    of the plain version before the last bf16 rounding."""
    rng = np.random.default_rng(m * 10 + cluster)
    b, d = 6, 384
    t = np.tanh(rng.standard_normal((b, m, d))).astype(np.float32)
    a = (0.3 * rng.standard_normal(d)).astype(np.float32)
    mask = (rng.random((b, m)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, m // 2] = 1.0
    dcv = (0.05 * rng.standard_normal((b, d))).astype(np.float32)
    tt = torch.from_numpy(t).to(torch.bfloat16)
    ta, tm, tg = map(torch.from_numpy, (a, mask, dcv))
    _, attn = torch_attention(tt, ta, tm)
    want_dt, want_da = _jax_backward(tt.float().numpy(), a, mask, dcv)
    got_dt, got_da = attention.split_backward(tt, ta, tm, attn, tg, cluster)
    plain_dt, plain_da = masked_single_query_attention_backward(
        tt, ta, tm, attn, tg)
    for dt_, da_ in ((got_dt, got_da), (plain_dt, plain_da)):
        np.testing.assert_allclose(dt_.float().numpy(), want_dt, **BF16)
        np.testing.assert_allclose(da_.numpy(), want_da, **BF16)
    assert not got_dt[0].any()
    np.testing.assert_allclose(got_dt.float().numpy(),
                               plain_dt.float().numpy(), **BF16)
