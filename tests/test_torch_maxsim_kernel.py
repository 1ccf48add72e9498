"""The port's fused MaxSim (plain version on the CPU, CUDA kernel on a card)
against the JAX package's Pallas kernel in interpret mode.

Both sides multiply the same bf16 values exactly and sum in f32, in other
orders: scores agree to rtol 1e-5, atol 1e-5 (|scores| here are below 30).

JAX is imported only by the tests that compare with it, so that the card
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_maxsim_kernel.py
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (TILING_CASES and their inputs; imports no JAX)
from nextplaid_tpu_torch.ops import maxsim_kernel  # noqa: E402
from nextplaid_tpu_torch.ops.maxsim_kernel import (  # noqa: E402
    maxsim_grid_scores,
    maxsim_grid_scores_reference,
    plan_launch,
)

TILING_IDS = [case[0] for case in chip_smoke.TILING_CASES]


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


@pytest.mark.parametrize("case", chip_smoke.TILING_CASES, ids=TILING_IDS)
def test_tiling_cases_plain_version_matches_jax_interpret(case):
    """The shapes a 64-row tiling can get wrong (doc lengths 63/64/65/128/Td,
    one doc, few and many columns, other d), plain version against the
    Pallas kernel in interpret mode: 1e-4 x max|score|. The Pallas kernel
    takes grid rows in multiples of 8, so its grid is padded with empty
    docs whose columns are dropped."""
    qflat, grid, lens = chip_smoke.tiling_case_arrays(case)
    tq, nd = case[2], case[3]
    pad = -nd % 8
    want = _jax_scores(
        qflat, np.pad(grid, ((0, pad), (0, 0), (0, 0))), np.pad(lens, (0, pad)), tq
    )[:, :nd]
    got = maxsim_grid_scores(*chip_smoke.tiling_case_bf16(case, "cpu")).numpy()
    assert got.shape == want.shape == (case[1], nd)
    tol = 1e-4 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert (got[:, lens == 0] == 0).all()


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


@pytest.mark.cuda
def test_kernel_writes_every_query_of_a_warpgroup(cuda):
    """600 one-token queries: two warpgroups of 256 columns, each owning 256
    queries, more than its 128 threads. Every query's score is written, and
    the 0 of each empty doc: rtol 1e-5, atol 1e-4."""
    q_n, nd, td, d = 600, 2200, 40, 128  # 8 docs a block
    rng = np.random.default_rng(600)
    qflat = rng.standard_normal((q_n, d)).astype(np.float32)
    grid = rng.standard_normal((nd, td, d)).astype(np.float32)
    lens = rng.integers(0, td + 1, size=nd).astype(np.int32)
    lens[[3, 50]] = 0
    for i in range(nd):
        grid[i, lens[i]:] = 0.0
    plan = plan_launch(q_n, 1, nd, d * 2, scales=False)
    assert (plan.n, plan.n_wg, plan.qpw, plan.dpb) == (256, 2, 256, 8)
    args = (_bf16(qflat).to(cuda), _bf16(grid).to(cuda), torch.from_numpy(lens).to(cuda), 1)
    got = maxsim_grid_scores(*args)
    want = maxsim_grid_scores_reference(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-4)
    assert bool((got[:, torch.from_numpy(lens == 0).to(cuda)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.TILING_CASES, ids=TILING_IDS)
def test_tiling_cases_kernel_matches_plain_version(cuda, case):
    """Kernel vs plain version on the card: 1e-4 x max|score|."""
    args = chip_smoke.tiling_case_bf16(case, cuda)
    before = maxsim_kernel.maxsim_grid_scores.launches
    got = maxsim_grid_scores(*args)
    torch.cuda.synchronize()
    assert maxsim_kernel.maxsim_grid_scores.launches == before + 1
    want = maxsim_grid_scores_reference(*args)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("scales", [False, True])
def test_smem_bytes_match_the_kernels_layout(cuda, scales):
    """The Python plan's shared-memory bytes are the CUDA side's."""
    lib = maxsim_kernel._library_int8() if scales else maxsim_kernel._library()
    fn = lib.maxsim_int8_smem_bytes if scales else lib.maxsim_bf16_smem_bytes
    for n in maxsim_kernel.WGMMA_COLS:
        for n_wg in (1, 2):
            for panels in (1, 2, 4):
                for stages in (2, 5, 8):
                    assert fn(n, n_wg, panels, stages) == maxsim_kernel.smem_bytes(
                        n, n_wg, panels, stages, scales)


# --- the launch plan (pure Python) -----------------------------------------


@pytest.mark.parametrize(
    "q_n,tq,nd,row_bytes,scales,n,n_wg,qpw,dpb",
    [
        (320, 32, 5696, 256, False, 256, 2, 8, 16),   # SciFact bf16 pass
        (64, 32, 65536, 256, False, 256, 2, 8, 16),   # staged stage 4
        (64, 32, 118272, 128, True, 256, 2, 8, 64),   # a grid-only bucket (int8 wide: 64 docs)
        (1, 32, 118272, 128, True, 32, 1, 1, 16),     # one query: 32 columns, not 512
        (2, 32, 4096, 128, True, 32, 2, 1, 4),        # 4,096 docs: 4 a block fills the SMs
        (3, 32, 4096, 256, False, 64, 2, 2, 4),
        (5, 32, 77, 256, False, 128, 2, 4, 1),        # few docs: one doc a block
        (3, 200, 10, 512, False, 256, 1, 1, 1),       # d 256, tq 200: one warpgroup fits
        (17, 48, 10, 384, False, 256, 1, 5, 1),
        (1, 8, 37, 256, False, 32, 1, 4, 1),
    ],
)
def test_plan_launch_picks_instance_and_block(q_n, tq, nd, row_bytes, scales, n, n_wg, qpw, dpb):
    plan = plan_launch(q_n, tq, nd, row_bytes, scales)
    assert (plan.n, plan.n_wg, plan.qpw, plan.dpb) == (n, n_wg, qpw, dpb)
    assert plan.panels == row_bytes // 128


@pytest.mark.parametrize(
    "scales,row_bytes",
    [(False, 128), (False, 256), (False, 384), (False, 512), (True, 128), (True, 256)],
)
def test_plan_launch_fits_shared_memory(scales, row_bytes):
    """Every plan holds whole queries, fits a block's 232,448 bytes with a
    ring of at least 2 tiles, and agrees with `smem_bytes`."""
    for tq in (1, 8, 24, 32, 33, 48, 64, 100, 128, 130, 200, 256):
        for q_n in (1, 2, 3, 8, 9, 16, 17, 64, 320):
            for nd in (1, 77, 5696, 131072):
                plan = plan_launch(q_n, tq, nd, row_bytes, scales)
                assert plan.n in maxsim_kernel.WGMMA_COLS and plan.n >= tq
                assert plan.qpw == plan.n // tq >= 1 and plan.n_wg in (1, 2)
                assert 2 <= plan.stages <= maxsim_kernel.MAX_STAGES
                assert 1 <= plan.dpb <= maxsim_kernel.MAX_DOCS_PER_BLOCK
                assert plan.smem <= maxsim_kernel.SMEM_LIMIT
                assert plan.smem == maxsim_kernel.smem_bytes(
                    plan.n, plan.n_wg, plan.panels, plan.stages, scales)
                if plan.n <= 64:  # two blocks an SM
                    assert 2 * plan.smem <= maxsim_kernel.SMEM_LIMIT
                # Where two warpgroups of 256 columns hold every query (and
                # fit: rows up to 256 bytes), the plan holds them too.
                if row_bytes <= 256 and 2 * (256 // tq) >= q_n:
                    assert plan.n_wg * plan.qpw >= q_n


def test_plan_launch_rejects_bad_shapes():
    with pytest.raises(ValueError):
        plan_launch(4, 32, 100, 100, False)  # rows are whole 128-byte panels
    with pytest.raises(ValueError):
        plan_launch(4, 257, 100, 256, False)
    with pytest.raises(ValueError):
        plan_launch(4, 0, 100, 256, False)


@pytest.mark.parametrize("d,d_k", [(16, 64), (48, 64), (64, 64), (96, 128), (128, 128), (208, 256)])
def test_pad_bf16_inputs_keeps_scores(d, d_k):
    """Zero features pad d to whole panels and change no score."""
    qflat, grid, lens = _inputs(d, 3, 8, 8, 24, d)
    q, g = _bf16(qflat), _bf16(grid)
    qp, gp = maxsim_kernel.pad_bf16_inputs(q, g)
    assert qp.shape == (24, d_k) and gp.shape == (8, 24, d_k)
    assert (qp is q and gp is g) == (d == d_k)
    lens_t = torch.from_numpy(lens)
    np.testing.assert_array_equal(
        maxsim_grid_scores_reference(qp, gp, lens_t, 8).numpy(),
        maxsim_grid_scores_reference(q, g, lens_t, 8).numpy(),
    )


def test_build_tag_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/maxsim_wgmma.cuh rebuilds both served kernels and the
    variant family, all three instances of its template."""
    assert maxsim_kernel.HEADER_WGMMA.exists()
    for src in maxsim_kernel.SOURCES:
        assert maxsim_kernel.HEADER_WGMMA in maxsim_kernel.HEADERS[src]
        assert '#include "maxsim_wgmma.cuh"' in src.read_text()
    assert "mma.sync" not in maxsim_kernel.SOURCE_VARIANTS.read_text()
    before = {src: maxsim_kernel.build_tag(src) for src in maxsim_kernel.SOURCES}
    edited = tmp_path / "maxsim_wgmma.cuh"
    edited.write_bytes(maxsim_kernel.HEADER_WGMMA.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(
        maxsim_kernel, "HEADERS",
        {src: tuple(edited if h == maxsim_kernel.HEADER_WGMMA else h for h in hs)
         for src, hs in maxsim_kernel.HEADERS.items()},
    )
    after = {src: maxsim_kernel.build_tag(src) for src in maxsim_kernel.SOURCES}
    assert after[maxsim_kernel.SOURCE] != before[maxsim_kernel.SOURCE]
    assert after[maxsim_kernel.SOURCE_INT8] != before[maxsim_kernel.SOURCE_INT8]
    assert after[maxsim_kernel.SOURCE_VARIANTS] != before[maxsim_kernel.SOURCE_VARIANTS]


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxsim_pairwise_matches_jax(seed):
    """ops.maxsim.maxsim_pairwise against nextplaid_tpu.ops.maxsim's on
    random masks, with a fully masked doc slab row and a fully masked query:
    rtol 1e-5, atol 1e-5 (f32 sums in other orders)."""
    import jax.numpy as jnp

    from nextplaid_tpu.ops import maxsim as jax_maxsim
    from nextplaid_tpu_torch.ops.maxsim import maxsim_pairwise

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, 6, 16)).astype(np.float32)
    docs = rng.standard_normal((4, 5, 9, 16)).astype(np.float32)
    qmask = rng.random((4, 6)) < 0.7
    dmask = rng.random((4, 5, 9)) < 0.6
    dmask[1, 3] = False  # a doc with no real token scores 0
    qmask[2] = False  # a query with no real token scores 0 everywhere
    args = (q, docs, qmask, dmask)
    got = maxsim_pairwise(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jax_maxsim.maxsim_pairwise(*map(jnp.asarray, args)))
    assert got.shape == want.shape == (4, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[1, 3] == 0 and (got[2] == 0).all()


FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.5)
with open(out, "w") as f:
    f.write("library")
print("ptxas info    : Used 1 registers", file=sys.stderr)
"""


def test_build_library_once_under_threads(tmp_path, monkeypatch):
    """Threads that ask for one library at once wait for one nvcc (a server's
    first searches arrive on several executor threads); different sources
    still build side by side; no temporary file is left behind."""
    import threading

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(maxsim_kernel, "BUILD_DIR", tmp_path / "build")
    sources = [maxsim_kernel.SOURCE] * 4 + [maxsim_kernel.SOURCE_INT8] * 2
    barrier = threading.Barrier(len(sources))
    results, errors = [None] * len(sources), []

    def build(i):
        barrier.wait()
        try:
            results[i] = maxsim_kernel.build_library(sources[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(len(sources))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []
    lines = calls.read_text().split()
    assert len(lines) == 2 and len(set(lines)) == 2  # one nvcc a source
    assert time.perf_counter() - t0 < 0.95  # the two sources built at once
    assert len({results[i] for i in range(4)}) == 1 and results[0].read_text() == "library"
    assert results[4] == results[5] != results[0]
    assert sorted(p.name for p in (tmp_path / "build").iterdir() if p.suffix == ".tmp") == []
    # A loader behind `load_once` runs once, however many threads ask.
    loads = []

    @maxsim_kernel.load_once
    def loader():
        loads.append(1)
        time.sleep(0.2)
        return object()

    got = []
    threads = [threading.Thread(target=lambda: got.append(loader())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(loads) == 1 and len(got) == 4 and len({id(g) for g in got}) == 1
