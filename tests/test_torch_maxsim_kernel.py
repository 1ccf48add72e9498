"""The port's fused MaxSim (plain version on the CPU, CUDA kernel on a card)
against the JAX package's Pallas kernel in interpret mode.

Both sides multiply the same bf16 values exactly and sum in f32, in other
orders: scores agree to rtol 1e-5, atol 1e-5 (|scores| here are below 30).

JAX is imported only by the tests that compare with it, so that the card
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_maxsim_kernel.py
"""

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.ops import maxsim_kernel
from nextplaid_tpu_torch.ops.maxsim_kernel import (
    maxsim_grid_scores,
    maxsim_grid_scores_reference,
)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def _inputs(seed, q_n, tq, nd, td, d):
    """Queries with padded (zero) tokens, a grid with zero-length docs,
    ragged lengths and one doc whose similarities to query 0 are all
    negative."""
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q_n, tq, d)).astype(np.float32)
    queries[:, tq - 3:] = 0.0  # padded query tokens are zero rows
    queries[0] = np.abs(queries[0])
    grid = rng.standard_normal((nd, td, d)).astype(np.float32)
    lens = rng.integers(1, td + 1, size=nd).astype(np.int32)
    lens[[2, nd - 1]] = 0  # empty and padding docs
    lens[1] = min(5, td)
    grid[1] = -np.abs(grid[1])  # every similarity with query 0 is negative
    for i in range(nd):
        grid[i, lens[i]:] = 0.0
    return queries.reshape(q_n * tq, d), grid, lens


def _jax_scores(qflat, grid, lens, tq):
    import jax.numpy as jnp

    from nextplaid_tpu.ops.maxsim_kernel import (
        maxsim_grid_scores as jax_maxsim_grid_scores,
    )

    return np.asarray(
        jax_maxsim_grid_scores(
            jnp.asarray(qflat, jnp.bfloat16),
            jnp.asarray(grid, jnp.bfloat16),
            jnp.asarray(lens[:, None]),
            tq=tq,
            interpret=True,
        )
    )


@pytest.mark.parametrize(
    "q_n,tq,nd,td,d",
    [(4, 8, 8, 24, 128), (3, 16, 16, 40, 128), (2, 32, 8, 8, 64)],
)
def test_plain_version_matches_jax_interpret(q_n, tq, nd, td, d):
    qflat, grid, lens = _inputs(q_n + nd, q_n, tq, nd, td, d)
    want = _jax_scores(qflat, grid, lens, tq)
    got = maxsim_grid_scores(
        _bf16(qflat), _bf16(grid), torch.from_numpy(lens), tq=tq
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, lens == 0] == 0).all()  # empty docs score exactly 0
    assert got[0, 1] < 0  # masked by length, not by zero rows


def test_plain_version_tiles_docs():
    qflat, grid, lens = _inputs(7, 2, 8, 16, 24, 32)
    args = (_bf16(qflat), _bf16(grid), torch.from_numpy(lens), 8)
    whole = maxsim_grid_scores_reference(*args)
    tiled = maxsim_grid_scores_reference(*args, block_bytes=16 * 24 * 4 * 3)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_cpu_tensors_do_not_launch():
    before = maxsim_grid_scores.launches
    qflat, grid, lens = _inputs(8, 1, 8, 8, 8, 32)
    maxsim_grid_scores(_bf16(qflat), _bf16(grid), torch.from_numpy(lens), tq=8)
    assert maxsim_grid_scores.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_n,tq,nd,td,d",
    [(4, 8, 8, 24, 128), (5, 32, 77, 40, 128), (9, 48, 64, 304, 128),
     (3, 16, 16, 8, 64)],
)
def test_kernel_matches_plain_version(cuda, q_n, tq, nd, td, d):
    """Kernel vs plain version on the card: rtol 1e-5, atol 1e-4."""
    qflat, grid, lens = _inputs(q_n * nd, q_n, tq, nd, td, d)
    args = (_bf16(qflat).to(cuda), _bf16(grid).to(cuda),
            torch.from_numpy(lens).to(cuda), tq)
    before = maxsim_kernel.maxsim_grid_scores.launches
    got = maxsim_grid_scores(*args)
    torch.cuda.synchronize()
    assert maxsim_kernel.maxsim_grid_scores.launches == before + 1
    want = maxsim_grid_scores_reference(*args)
    np.testing.assert_allclose(
        got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_maxsim_oracle_matches_jax(seed):
    """ops.maxsim (the plain f32 oracle) against nextplaid_tpu.ops.maxsim:
    rtol 1e-5, atol 1e-5 (f32 sums in other orders)."""
    import jax.numpy as jnp

    from nextplaid_tpu.ops import maxsim as jax_maxsim
    from nextplaid_tpu_torch.ops.maxsim import maxsim_batch, maxsim_score

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 6, 16)).astype(np.float32)
    docs = rng.standard_normal((5, 9, 16)).astype(np.float32)
    qmask = rng.random((3, 6)) < 0.8
    dmask = rng.random((5, 9)) < 0.7
    dmask[2] = False  # a doc with no real token scores 0
    got = maxsim_batch(*map(torch.from_numpy, (q, docs, qmask, dmask))).numpy()
    want = np.asarray(jax_maxsim.maxsim_batch(*map(jnp.asarray, (q, docs, qmask, dmask))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, 2] == 0).all()
    one = float(maxsim_score(torch.from_numpy(q[0]), torch.from_numpy(docs[0])))
    np.testing.assert_allclose(
        one, float(jax_maxsim.maxsim_score(jnp.asarray(q[0]), jnp.asarray(docs[0]))),
        rtol=1e-5, atol=1e-5,
    )
