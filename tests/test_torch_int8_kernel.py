"""The port's int8 MaxSim (plain version on the CPU, CUDA kernel on a card)
against the JAX package's Pallas kernel in interpret mode, plus the query
quantization and the grid layout conversion it depends on.

The int32 dots are exact on both sides and the per-token values are equal
bit for bit; only the f32 sum over query tokens runs in another order. So
scores agree to 1e-5 x max|score|.

JAX is imported only by the tests that compare with it, so that the card
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_int8_kernel.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (TILING_CASES and their inputs; imports no JAX)
from nextplaid_tpu_torch.index.container import (  # noqa: E402
    int8_grid_from_interleaved,
    int8_grid_to_interleaved,
)
from nextplaid_tpu_torch.index.exact import quantize_queries_int8  # noqa: E402
from nextplaid_tpu_torch.ops import maxsim_kernel  # noqa: E402
from nextplaid_tpu_torch.ops.maxsim_kernel import (  # noqa: E402
    maxsim_grid_scores_int8i,
    maxsim_grid_scores_int8i_reference,
)

RTOL = 1e-5  # of max|score|
TILING_IDS = [case[0] for case in chip_smoke.TILING_CASES]


def _bf16_values(x):
    """float32 array of the bf16 values nearest to x."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _inputs(seed, q_n, tq, nd, td, d):
    """int8 queries with zero-scale padded tokens; a doc-major int8 grid with
    ragged valid lengths, docs with no valid token, a doc whose dots with
    query 0 are all negative, and a real all-zero token (scale 1.0)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (q_n, tq, d)).astype(np.int8)
    qscale = rng.uniform(0.002, 0.01, (q_n, tq)).astype(np.float32)
    q[:, tq - 3 :] = 0
    qscale[:, tq - 3 :] = 0.0  # padded query tokens
    q[0] = np.abs(q[0].astype(np.int16)).clip(0, 127).astype(np.int8)
    grid = rng.integers(-127, 128, (nd, td, d)).astype(np.int8)
    scales = _bf16_values(rng.uniform(0.002, 0.01, (nd, td)))
    lens = rng.integers(1, td + 1, nd)
    lens[[2, 40 % nd, nd - 1]] = 0  # docs with no valid token
    lens[1] = min(5, td)
    grid[1] = -np.abs(grid[1].astype(np.int16)).clip(0, 127).astype(np.int8)
    for i in range(nd):
        grid[i, lens[i] :] = 0
        scales[i, lens[i] :] = 0.0
    lens[5] = max(lens[5], 1)
    grid[5, 0] = 0
    scales[5, 0] = 1.0  # a real all-zero token: valid, dots 0
    return q.reshape(q_n * tq, d), qscale.reshape(-1), grid, scales


def _torch(q, qscale, grid, scales):
    return (
        torch.from_numpy(q),
        torch.from_numpy(qscale),
        torch.from_numpy(grid),
        torch.from_numpy(scales).to(torch.bfloat16),
    )


def _jax_scores(q, qscale, grid, scales, tq):
    import jax.numpy as jnp

    from nextplaid_tpu.ops.maxsim_kernel import (
        maxsim_grid_scores_int8i as jax_int8,
    )

    grid_i, scales_i = int8_grid_to_interleaved(
        torch.from_numpy(grid), torch.from_numpy(scales).to(torch.bfloat16)
    )
    return np.asarray(
        jax_int8(
            jnp.asarray(q),
            jnp.asarray(qscale),
            jnp.asarray(grid_i.numpy()),
            jnp.asarray(scales_i.float().numpy(), jnp.bfloat16),
            tq=tq,
            interpret=True,
        )
    )


@pytest.mark.parametrize(
    "q_n,tq,nd,td,d",
    [(3, 16, 128, 64, 128), (2, 8, 256, 32, 64), (4, 24, 128, 96, 32)],
)
def test_plain_version_matches_jax_interpret(q_n, tq, nd, td, d):
    q, qscale, grid, scales = _inputs(q_n + td, q_n, tq, nd, td, d)
    want = _jax_scores(q, qscale, grid, scales, tq)
    got = maxsim_grid_scores_int8i(*_torch(q, qscale, grid, scales), tq=tq).numpy()
    assert got.shape == want.shape == (q_n, nd)
    tol = RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    empty = scales.max(axis=1) == 0
    assert (got[:, empty] == 0).all()  # no valid token: exactly 0
    assert got[0, 1] < 0  # masked by scale, not by zero rows
    assert np.isfinite(got).all()


@pytest.mark.parametrize("case", chip_smoke.TILING_CASES, ids=TILING_IDS)
def test_tiling_cases_plain_version_matches_jax_interpret(case):
    """The shapes a 64-row tiling can get wrong, each with invalid tokens
    (scale 0) before valid ones, plain version against the Pallas kernel in
    interpret mode: sums to 1e-5 x max|score|. The Pallas kernel takes docs
    in groups of 128 and Td in multiples of 32 (as the JAX package pins its
    grids), so its grid is padded with zero-scale tokens and with docs that
    have no valid token, whose columns are dropped."""
    q, qs, grid, scales, tq = chip_smoke.tiling_case_int8(case, "cpu")
    nd, td = grid.shape[:2]
    pad, pad_t = -nd % 128, -td % 32
    want = _jax_scores(
        q.numpy(), qs.numpy(), np.pad(grid.numpy(), ((0, pad), (0, pad_t), (0, 0))),
        np.pad(scales.float().numpy(), ((0, pad), (0, pad_t))), tq,
    )[:, :nd]
    got = maxsim_grid_scores_int8i(q, qs, grid, scales, tq=tq).numpy()
    assert got.shape == want.shape == (case[1], nd)
    tol = RTOL * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    empty = scales.float().numpy().max(axis=1) == 0
    assert (got[:, empty] == 0).all()


def test_per_token_values_are_exact():
    """Per-token values of the plain version equal float(int32 dot) * scale
    bit for bit (the contract the kernel's epilogue keeps): one query token,
    so a score is one value times the query scale."""
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (1, 128)).astype(np.int8)
    grid = rng.integers(-127, 128, (16, 70, 128)).astype(np.int8)
    scales = _bf16_values(rng.uniform(0.002, 0.01, (16, 70)))
    scales[:, 3::5] = 0.0
    qs = np.array([0.5], np.float32)
    got = maxsim_grid_scores_int8i(*_torch(q, qs, grid, scales), tq=1).numpy()[0]
    dots = grid.astype(np.int32) @ q[0].astype(np.int32)  # [16, 70]
    vals = np.where(scales > 0, dots.astype(np.float32) * scales, -np.inf)
    np.testing.assert_array_equal(got, np.float32(0.5) * vals.max(axis=1))


@pytest.mark.parametrize("td,d,td_k,d_k", [(33, 32, 40, 128), (64, 128, 64, 128),
                                           (70, 96, 72, 128), (100, 160, 104, 256)])
def test_pad_int8_inputs_keeps_scores(td, d, td_k, d_k):
    """Zero features and zero-scale tokens pad d and Td for the kernel and
    change no score."""
    q, qscale, grid, scales = _inputs(td, 2, 8, 64, td, d)
    tq_, tqs, tg, ts = _torch(q, qscale, grid, scales)
    pq, pg, ps = maxsim_kernel.pad_int8_inputs(tq_, tg, ts)
    assert pq.shape == (16, d_k) and pg.shape == (64, td_k, d_k) and ps.shape == (64, td_k)
    assert (pg is tg) == ((td, d) == (td_k, d_k))
    np.testing.assert_array_equal(
        maxsim_grid_scores_int8i_reference(pq, tqs, pg, ps, tq=8).numpy(),
        maxsim_grid_scores_int8i_reference(tq_, tqs, tg, ts, tq=8).numpy(),
    )


def test_plain_version_tiles_docs():
    q, qscale, grid, scales = _inputs(5, 2, 8, 128, 32, 64)
    args = _torch(q, qscale, grid, scales)
    whole = maxsim_grid_scores_int8i_reference(*args, tq=8)
    tiled = maxsim_grid_scores_int8i_reference(*args, tq=8, block_bytes=16 * 32 * 4 * 5)
    # Same per-token values; the vectorized f32 sum may take another order.
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_do_not_launch():
    before = maxsim_grid_scores_int8i.launches
    q, qscale, grid, scales = _inputs(6, 1, 8, 128, 32, 32)
    maxsim_grid_scores_int8i(*_torch(q, qscale, grid, scales), tq=8)
    assert maxsim_grid_scores_int8i.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_queries_matches_jax_bit_exact(seed):
    import jax.numpy as jnp

    from nextplaid_tpu.index.exact import quantize_queries_int8 as jax_quantize

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    x[3] = 0.0  # a padded token: scale 0, row 0
    # Rows whose scale is exactly 1.0, with values on rounding ties
    # (round half to even on both sides).
    x[7] = np.linspace(-127, 127, 32).astype(np.float32)
    x[7, :6] = [2.5, -3.5, 0.5, -0.5, 126.5, 127.0]
    x[8] = 1e-30  # tiny but nonzero
    qi8, qs = quantize_queries_int8(torch.from_numpy(x))
    want_q, want_s = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(want_s))
    assert qs[3] == 0 and (qi8[3] == 0).all()


def test_layout_conversion_round_trip():
    rng = np.random.default_rng(2)
    grid = torch.from_numpy(rng.integers(-127, 128, (256, 64, 16)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0, 1, (256, 64)).astype(np.float32)).to(torch.bfloat16)
    grid_i, scales_i = int8_grid_to_interleaved(grid, scales)
    assert grid_i.shape == (2, 16, 128 * 64) and scales_i.shape == (2, 128 * 64)
    # Doc g*128 + j, token t sits at lane t*128 + j of group g.
    g, j, t = 1, 37, 11
    assert torch.equal(grid_i[g, :, t * 128 + j], grid[g * 128 + j, t])
    assert scales_i[g, t * 128 + j] == scales[g * 128 + j, t]
    back, back_s = int8_grid_from_interleaved(grid_i, scales_i)
    assert torch.equal(back, grid) and torch.equal(back_s, scales)


# --- the hand-off schedule (every int8 instance) ---------------------------

# The `lotte.int8.window2` cell: 64 queries of 32 tokens against the pinned
# LoTTE grid (Td 224, d 128, doc lengths uniform 100-220).
CELL_Q, CELL_TQ, CELL_TD, CELL_D, CELL_ND = 64, 32, 224, 128, 119461


def test_plan_launch_gives_the_cell_the_hand_off_instance():
    """The cell's shape gets two warpgroups of 256 columns, 64 docs a block
    (a wide instance) and a ring of 8 tiles."""
    plan = maxsim_kernel.plan_launch(CELL_Q, CELL_TQ, CELL_ND, CELL_D, scales=True)
    assert (plan.n, plan.n_wg, plan.qpw, plan.dpb, plan.stages) == (256, 2, 8, 64, 8)
    assert plan.n >= maxsim_kernel.INT8_WIDE_COLS
    assert plan.smem == maxsim_kernel.smem_bytes(256, 2, 1, 8, True)


@pytest.mark.parametrize("nd,dpb", [(118272, 16), (4096, 4), (77, 1)])
def test_plan_launch_keeps_one_query_narrow(nd, dpb):
    """One query keeps the narrow instance and its plan: 32 columns, docs a
    block from 16 down, and half an SM's shared memory, so that two blocks
    share it."""
    plan = maxsim_kernel.plan_launch(1, CELL_TQ, nd, CELL_D, scales=True)
    assert (plan.n, plan.n_wg, plan.qpw, plan.dpb, plan.stages) == (32, 1, 1, dpb, 8)
    assert plan.n < maxsim_kernel.INT8_WIDE_COLS
    assert 2 * plan.smem <= maxsim_kernel.SMEM_LIMIT


def _cell_inputs(seed, q_n, nd, lens, tq=CELL_TQ):
    """int8 inputs at the cell's widths: queries whose last tokens (3 of
    32; none below 4 tokens) are zero-padded (qscale 0), a doc-major grid
    whose rows past each doc's length are zero with scale 0, and a few
    zero-scale tokens inside docs."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (q_n, tq, CELL_D)).astype(np.int8)
    qscale = rng.uniform(0.002, 0.01, (q_n, tq)).astype(np.float32)
    pad = min(3, tq // 4)
    q[:, tq - pad :] = 0
    qscale[:, tq - pad :] = 0.0
    grid = rng.integers(-127, 128, (nd, CELL_TD, CELL_D)).astype(np.int8)
    scales = _bf16_values(rng.uniform(0.002, 0.01, (nd, CELL_TD)))
    scales[::7, 5::31] = 0.0  # masked tokens inside docs
    for i, n in enumerate(lens):
        grid[i, n:] = 0
        scales[i, n:] = 0.0
    return q.reshape(q_n * tq, CELL_D), qscale.reshape(-1), grid, scales


def _token_order_scores(queries, qscales, grid, scales, tq):
    """qscale x max over valid rows of float(dot) x scale for every query
    token and doc (the plain version's per-token terms: a query of one
    token), summed over each query's tokens in token order in f32, as the
    kernel sums them."""
    terms = maxsim_grid_scores_int8i_reference(queries, qscales, grid, scales, tq=1)
    terms = terms.view(-1, tq, grid.shape[0])
    out = torch.zeros_like(terms[:, 0])
    for t in range(tq):
        out = out + terms[:, t]
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_n,tq,nd,td,d",
    [(3, 16, 128, 64, 128), (64, 32, 300, 224, 128), (5, 20, 77, 40, 96),
     (2, 8, 64, 33, 32), (1, 32, 512, 128, 128), (8, 32, 130, 100, 128),
     (8, 32, 40, 64, 256), (3, 16, 40, 64, 256)],
)
def test_kernel_matches_plain_version(cuda, q_n, tq, nd, td, d):
    """Kernel vs plain version on the card: atol 1e-5 x max|score|."""
    q, qscale, grid, scales = _inputs(q_n * nd, q_n, tq, nd, td, d)
    args = tuple(a.to(cuda) for a in _torch(q, qscale, grid, scales))
    before = maxsim_grid_scores_int8i.launches
    got = maxsim_grid_scores_int8i(*args, tq=tq)
    torch.cuda.synchronize()
    assert maxsim_grid_scores_int8i.launches == before + 1
    want = maxsim_grid_scores_int8i_reference(*args, tq=tq)
    tol = RTOL * float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.TILING_CASES, ids=TILING_IDS)
def test_tiling_cases_kernel_matches_plain_version(cuda, case):
    """Kernel vs plain version on the card: atol 1e-5 x max|score|."""
    args = chip_smoke.tiling_case_int8(case, cuda)
    before = maxsim_grid_scores_int8i.launches
    got = maxsim_grid_scores_int8i(*args)
    torch.cuda.synchronize()
    assert maxsim_grid_scores_int8i.launches == before + 1
    want = maxsim_grid_scores_int8i_reference(*args)
    tol = RTOL * max(float(want.abs().max()), 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_per_token_values_are_exact_on_the_card(cuda):
    """One query token: the kernel's score is float(int32 dot) * scale times
    the query scale, bit for bit with the plain version."""
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (1, 128)).astype(np.int8)
    grid = rng.integers(-127, 128, (300, 200, 128)).astype(np.int8)
    scales = _bf16_values(rng.uniform(0.002, 0.01, (300, 200)))
    scales[:, 3::5] = 0.0
    args = tuple(a.to(cuda) for a in _torch(q, np.array([0.5], np.float32), grid, scales))
    got = maxsim_grid_scores_int8i(*args, tq=1)
    want = maxsim_grid_scores_int8i_reference(*args, tq=1)
    assert torch.equal(got, want)


def _edge_lens(rng, nd):
    return rng.choice([0, 64, 65, 128, 129, 224], nd)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_n,nd,lens",
    [
        (CELL_Q, 3001, "cell"),  # the cell: 64 queries, 2 x 256 columns a block
        (CELL_Q, 1500, "edges"),  # no valid token; 64, 65, 128, 129, Td rows
        (61, 2001, "cell"),  # the last warpgroup holds 5 queries
        (36, 1001, "edges"),  # 5 query groups: the last block has one warpgroup
        (6, 1999, "cell"),  # 128 columns a warpgroup
        (4, 2001, "cell"),  # 64 columns a warpgroup, two blocks an SM
        (1, 3001, "edges"),  # one query: 32 columns, one warpgroup
    ],
)
def test_hand_off_schedule_sums_in_token_order(cuda, q_n, nd, lens):
    """The hand-off schedule's scores equal, bit for bit, the token-order
    f32 sums of the plain version's per-token terms, with a doc count that
    is not a multiple of the docs a block walks."""
    rng = np.random.default_rng(q_n + nd)
    doc_lens = rng.integers(100, 221, nd) if lens == "cell" else _edge_lens(rng, nd)
    q, qscale, grid, scales = _cell_inputs(nd, q_n, nd, doc_lens)
    plan = maxsim_kernel.plan_launch(q_n, CELL_TQ, nd, CELL_D, scales=True)
    assert nd % plan.dpb != 0
    args = tuple(a.to(cuda) for a in _torch(q, qscale, grid, scales))
    before = maxsim_grid_scores_int8i.launches
    got = maxsim_grid_scores_int8i(*args, tq=CELL_TQ)
    torch.cuda.synchronize()
    assert maxsim_grid_scores_int8i.launches == before + 1
    want = _token_order_scores(*args, tq=CELL_TQ)
    assert torch.equal(got, want)
    empty = torch.from_numpy(scales.max(axis=1) == 0).to(cuda)
    if lens == "edges":
        assert bool(empty.any()) and bool((got[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_n,tq,n,qpw",
    [
        (200, 1, 128, 128),  # warpgroups of 128 and 72 one-token queries
        (64, 3, 128, 42),  # 42 and 22 queries of 3 tokens
        (600, 1, 256, 256),  # 256 one-token queries a warpgroup
    ],
)
def test_hand_off_schedule_writes_every_query(cuda, q_n, tq, n, qpw):
    """Where a warpgroup owns more than 32 queries, the finishing warp still
    writes each one's score, and the 0 of each doc with no valid token, bit
    for bit the token-order sums."""
    nd = 4500  # 4 to 8 docs a block
    rng = np.random.default_rng(q_n * tq)
    q, qscale, grid, scales = _cell_inputs(q_n + tq, q_n, nd, _edge_lens(rng, nd), tq=tq)
    plan = maxsim_kernel.plan_launch(q_n, tq, nd, CELL_D, scales=True)
    assert (plan.n, plan.qpw) == (n, qpw)
    args = tuple(a.to(cuda) for a in _torch(q, qscale, grid, scales))
    got = maxsim_grid_scores_int8i(*args, tq=tq)
    want = _token_order_scores(*args, tq=tq)
    assert torch.equal(got, want)
    empty = torch.from_numpy(scales.max(axis=1) == 0).to(cuda)
    assert bool(empty.any()) and bool((got[:, empty] == 0).all())
