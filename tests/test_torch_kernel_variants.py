"""The MaxSim variant family of the port (plain version on the CPU, CUDA
kernel on a card) against the Pallas variants of
scripts/profile_kernel_variants.py in interpret mode.

That script builds its 509 MB grid when imported, so the tests take only its
kernel functions: they are cut out of its source with `ast` and called
through a `pl.pallas_call` built here as its `build(...)` builds it, at a
small shape. Both sides multiply the same bf16 values exactly and sum in
f32, in other orders: scores agree to rtol 1e-5, atol 1e-4 (|scores| < 60);
the probe sums thousands of products per output, so it gets 1e-4 of its
largest |sum| (1e-3 on the card, where a block sums up to ~1e6 products).

JAX is imported only by the tests that compare with it, so that the card
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_kernel_variants.py
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.ops import maxsim_kernel as mk
from nextplaid_tpu_torch.ops import maxsim_variants as mv
from nextplaid_tpu_torch.ops.maxsim_kernel import NEG, maxsim_grid_scores_reference
from nextplaid_tpu_torch.ops.maxsim_variants import (
    SWEEP_VARIANTS,
    maxsim_variant_scores,
    maxsim_variant_scores_reference,
    one_big_dot_floor,
    sweep_inputs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "profile_kernel_variants.py")
RTOL, ATOL = 1e-5, 1e-4
RTOL_DOTS = 1e-4  # of the largest |sum|
# On the card the tensor cores add up to ~1e6 products per output in f32, in
# another order than the plain version's matmul and sums.
RTOL_DOTS_CARD = 1e-3

# (Pallas kernel, its mask input, needs scratch) -> the port's (mask, reduce).
PALLAS_VARIANTS = {
    "kernel_iota": ("lens", False, "lens", "registers"),
    "kernel_addmask": ("grid2d", False, "additive", "registers"),
    "kernel_addflat": ("flat", False, "additive", "registers"),
    "kernel_iota_scratch": ("lens", True, "lens", "shared"),
    "kernel_addflat_fold": ("flat", False, "additive", "shared"),
}


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def _inputs(seed, q_n, tq, nd, td, d):
    """Queries with padded (zero) tokens; a grid with empty docs, ragged
    lengths and one doc whose similarities to query 0 are all negative; the
    additive mask of the lengths."""
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q_n, tq, d)).astype(np.float32)
    queries[:, tq - 3:] = 0.0
    queries[0] = np.abs(queries[0])
    grid = rng.standard_normal((nd, td, d)).astype(np.float32)
    lens = rng.integers(1, td + 1, size=nd).astype(np.int32)
    lens[[2, nd - 1]] = 0
    lens[1] = min(5, td)
    grid[1] = -np.abs(grid[1])
    for i in range(nd):
        grid[i, lens[i]:] = 0.0
    addmask = np.where(np.arange(td)[None, :] < lens[:, None], 0.0, NEG).astype(np.float32)
    return queries.reshape(q_n * tq, d), grid, lens, addmask


@functools.lru_cache(maxsize=None)
def _pallas_kernels():
    """The script's kernel_* functions, without running its module body."""
    import jax
    import jax.numpy as jnp

    with open(SCRIPT) as f:
        tree = ast.parse(f.read(), SCRIPT)
    funcs = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("kernel_")]
    namespace = {"jax": jax, "jnp": jnp, "NEG": NEG}
    exec(compile(ast.Module(funcs, []), SCRIPT, "exec"), namespace)
    return {f.name: namespace[f.name] for f in funcs}


def _pallas_scores(name, qflat, grid, lens, addmask, tq, dblk, sub):
    """The script's `build(kernel, dblk, sub, mask_mode, scratch=...)` at this
    shape, in interpret mode. Returns [ND, Q] f32."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    mask_mode, scratch = (PALLAS_VARIANTS.get(name) or ("lens", False))[:2]
    nd, td, d = grid.shape
    qf = qflat.shape[0]
    q_n = qf // tq
    if mask_mode == "flat":
        third_spec = pl.BlockSpec((dblk * td, 1), lambda i: (i, 0), memory_space=pltpu.VMEM)
        third = jnp.asarray(addmask.reshape(nd * td, 1))
    elif mask_mode == "grid2d":
        third_spec = pl.BlockSpec((dblk, td), lambda i: (i, 0), memory_space=pltpu.VMEM)
        third = jnp.asarray(addmask)
    else:
        third_spec = pl.BlockSpec((dblk, 1), lambda i: (i, 0), memory_space=pltpu.VMEM)
        third = jnp.asarray(lens[:, None])
    kw = {"scratch_shapes": [pltpu.VMEM((dblk, qf), jnp.float32)]} if scratch else {}
    fn = pl.pallas_call(
        functools.partial(_pallas_kernels()[name], tq=tq, sub=sub),
        out_shape=jax.ShapeDtypeStruct((nd, q_n), jnp.float32),
        grid=(nd // dblk,),
        in_specs=[
            pl.BlockSpec((d, qf), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((dblk, td, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            third_spec,
        ],
        out_specs=pl.BlockSpec((dblk, q_n), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True,
        **kw,
    )
    return np.asarray(fn(jnp.asarray(qflat, jnp.bfloat16).T, jnp.asarray(grid, jnp.bfloat16), third))


def test_script_has_the_kernels_this_file_maps():
    assert set(_pallas_kernels()) == set(PALLAS_VARIANTS) | {"kernel_dotsonly"}


@pytest.mark.parametrize("dblk,sub", [(8, 2), (16, 1)])
@pytest.mark.parametrize("name", sorted(PALLAS_VARIANTS))
def test_plain_version_matches_pallas_variant(name, dblk, sub):
    # Td a power of two: kernel_addflat_fold halves a doc's rows and drops
    # the odd one out at any other length.
    q_n, tq, nd, td, d = 3, 8, 16, 32, 128
    qflat, grid, lens, addmask = _inputs(11, q_n, tq, nd, td, d)
    want = _pallas_scores(name, qflat, grid, lens, addmask, tq, dblk, sub)
    _, _, mask, reduce = PALLAS_VARIANTS[name]
    arg = torch.from_numpy(lens) if mask == "lens" else torch.from_numpy(addmask)
    got = maxsim_variant_scores(
        _bf16(qflat), _bf16(grid), arg, tq, mask=mask, geometry=(dblk, 64), reduce=reduce
    ).numpy()
    assert got.shape == (nd, q_n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[lens == 0] == 0).all()  # empty docs score exactly 0
    assert got[1, 0] < 0  # masked by the mask input, not by zero rows


@pytest.mark.parametrize("dblk,sub", [(8, 2), (16, 4), (4, 1)])
def test_plain_probe_matches_pallas_dotsonly(dblk, sub):
    q_n, tq, nd, td, d = 3, 8, 16, 24, 128
    qflat, grid, lens, addmask = _inputs(12, q_n, tq, nd, td, d)
    want = _pallas_scores("kernel_dotsonly", qflat, grid, lens, addmask, tq, dblk, sub)
    got = maxsim_variant_scores(
        _bf16(qflat), _bf16(grid), torch.from_numpy(lens), tq,
        geometry=(dblk, 64), dots_only=True,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_DOTS * np.abs(want).max())
    # The definition, by numpy: block sums over rows and query tokens.
    g = _bf16(grid).float().numpy().astype(np.float64)
    q = _bf16(qflat).float().numpy().astype(np.float64)
    per_doc = np.einsum("ntd,qd->nq", g, q).reshape(nd, q_n, tq).sum(2)
    block = per_doc.reshape(nd // dblk, dblk, q_n).sum(1).repeat(dblk, axis=0)
    np.testing.assert_allclose(got, block, rtol=0, atol=RTOL_DOTS * np.abs(block).max())


@pytest.mark.parametrize(
    "name,mask,geometry,reduce,dots", SWEEP_VARIANTS, ids=[v[0] for v in SWEEP_VARIANTS]
)
def test_sweep_variant_equals_transposed_maxsim(name, mask, geometry, reduce, dots):
    """Every variant of the sweep list, plain version: all but the probe equal
    `maxsim_grid_scores_reference(...).T`, for both mask inputs and both
    shapes of the additive mask."""
    q_n, tq, nd, td, d = 4, 8, 70, 24, 32
    qflat, grid, lens, addmask = _inputs(13, q_n, tq, nd, td, d)
    q_t, g_t, lens_t = _bf16(qflat), _bf16(grid), torch.from_numpy(lens)
    kw = dict(mask=mask, geometry=geometry, reduce=reduce, dots_only=dots)
    if dots:
        got = maxsim_variant_scores(q_t, g_t, lens_t, tq, **kw)
        tiled = maxsim_variant_scores_reference(q_t, g_t, lens_t, tq, block_bytes=1, **kw)
        np.testing.assert_allclose(got.numpy(), tiled.numpy(), rtol=0,
                                   atol=RTOL_DOTS * float(got.abs().max()))
        dpb = geometry[0]
        assert (got[:dpb] == got[0]).all()  # one value per block of docs
        return
    want = maxsim_grid_scores_reference(q_t, g_t, lens_t, tq).T
    args = [lens_t[:, None]] if mask == "lens" else [
        torch.from_numpy(addmask), torch.from_numpy(addmask.reshape(nd * td, 1))]
    for arg in args:
        got = maxsim_variant_scores(q_t, g_t, arg, tq, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
        assert (got.numpy()[lens == 0] == 0).all()


def test_additive_mask_need_not_be_a_prefix():
    """The additive mask may hide any row, not only a doc's tail."""
    q_n, tq, nd, td, d = 2, 8, 8, 16, 32
    qflat, grid, lens, _ = _inputs(14, q_n, tq, nd, td, d)
    rng = np.random.default_rng(0)
    hidden = rng.random((nd, td)) < 0.4
    hidden[3] = True  # a doc with every row hidden scores 0
    addmask = np.where(hidden, NEG, 0.0).astype(np.float32)
    got = maxsim_variant_scores(
        _bf16(qflat), _bf16(grid), torch.from_numpy(addmask), tq, mask="additive").numpy()
    sim = np.einsum("ntd,qd->ntq", _bf16(grid).float().numpy(), _bf16(qflat).float().numpy())
    sim = np.where(hidden[:, :, None], -np.inf, sim).max(axis=1)
    want = np.where(np.isfinite(sim), sim, 0.0).reshape(nd, q_n, tq).sum(2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[3] == 0).all()


def test_plain_version_tiles_docs():
    qflat, grid, lens, addmask = _inputs(15, 2, 8, 16, 24, 32)
    args = (_bf16(qflat), _bf16(grid), torch.from_numpy(addmask), 8)
    whole = maxsim_variant_scores_reference(*args, mask="additive")
    tiled = maxsim_variant_scores_reference(*args, mask="additive", block_bytes=1)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_cpu_tensors_do_not_launch_and_bad_variants_raise():
    before = maxsim_variant_scores.launches
    qflat, grid, lens, _ = _inputs(16, 1, 8, 8, 8, 32)
    args = (_bf16(qflat), _bf16(grid), torch.from_numpy(lens), 8)
    maxsim_variant_scores(*args)
    assert maxsim_variant_scores.launches == before
    for bad in (dict(mask="iota"), dict(reduce="fold"), dict(geometry=(16, 48)),
                dict(geometry=(16, 16)), dict(geometry=(16, 32)), dict(geometry=(16, 256)),
                dict(geometry=(0, 64)), dict(geometry=(65, 64))):
        with pytest.raises(ValueError):
            maxsim_variant_scores(*args, **bad)


# --- the family's launch plan (pure Python) --------------------------------

# Each sweep variant's plan at the sweep's shape (64 queries x 32 tokens,
# d 128): (N, warpgroups, ring stages). The shared reduction's scratch does
# not fit two warpgroups at N 256, so it takes N 128 with two.
SWEEP_PLANS = {
    "lens d64 r128 reg": (256, 2, 2), "lens d32 r64 reg": (256, 2, 5),
    "lens d16 r64 reg": (256, 2, 5), "lens d16 r128 reg": (256, 2, 2),
    "lens d8  r64 reg": (256, 2, 5), "add  d32 r64 reg": (256, 2, 5),
    "add  d16 r64 reg": (256, 2, 5), "add  d64 r128 reg": (256, 2, 2),
    "add  d16 r64 shm": (128, 2, 5), "add  d8  r64 shm": (128, 2, 5),
    "lens d32 r64 shm": (128, 2, 5), "lens d64 r128 shm": (128, 2, 2),
    "dots d16 r64": (256, 2, 5), "dots d64 r128": (256, 2, 2),
}


@pytest.mark.parametrize(
    "name,mask,geometry,reduce,dots", SWEEP_VARIANTS, ids=[v[0] for v in SWEEP_VARIANTS]
)
def test_variant_plan_at_the_sweep_shape(name, mask, geometry, reduce, dots):
    plan = mv.variant_plan(64, 32, 128, mask=mask, geometry=geometry, reduce=reduce,
                           dots_only=dots)
    assert (plan.n, plan.n_wg, plan.stages) == SWEEP_PLANS[name]
    assert (plan.dpb, plan.rows, plan.qpw, plan.panels) == (geometry[0], geometry[1],
                                                             plan.n // 32, 2)


@pytest.mark.parametrize("rows", mv.ROWS)
@pytest.mark.parametrize("additive,scratch", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_plan_variant_fits_shared_memory(additive, scratch, rows):
    """Every plan holds whole queries, keeps the caller's docs a block, and
    fits a block's 232,448 bytes (half of them at N <= 64) with a ring of 2
    to 8 stages, as `smem_bytes` counts them. Rows of up to 256 bytes (d up
    to 128) always have a plan; wider rows may not (two stages of 128 rows
    of d 256 beside the scratch, or beside N 256, exceed the block), and then
    the plan raises."""
    sub, side = rows // 64, 256 if additive else 0
    for row_bytes in (128, 256, 384, 512):
        for tq in (1, 8, 20, 32, 33, 100, 128, 136, 200, 256):
            for q_n in (1, 3, 9, 64, 320):
                for dpb in (1, 8, 64):
                    try:
                        plan = mk.plan_variant(q_n, tq, row_bytes, dpb, rows, additive, scratch)
                    except ValueError:
                        assert row_bytes > 256
                        continue
                    assert plan.n in mk.WGMMA_COLS and plan.n >= tq
                    assert plan.qpw == plan.n // tq >= 1 and plan.n_wg in (1, 2)
                    assert (plan.dpb, plan.rows, plan.panels) == (dpb, rows, row_bytes // 128)
                    assert 2 <= plan.stages <= mk.MAX_STAGES
                    assert plan.smem == mk.smem_bytes(plan.n, plan.n_wg, plan.panels,
                                                      plan.stages, False, sub, side, scratch)
                    limit = mk.SMEM_LIMIT if plan.n > 64 else mk.SMEM_LIMIT // 2 - 1024
                    assert plan.smem <= limit
                    if scratch and plan.n == 256 and row_bytes >= 256:
                        assert plan.n_wg == 1  # 2 x 64 x 264 f32 beside B does not fit


def test_plan_variant_rejects_bad_geometries():
    for args in ((4, 32, 256, 0, 64), (4, 32, 256, 65, 64), (4, 32, 256, 16, 32),
                 (4, 32, 256, 16, 256), (4, 32, 100, 16, 64), (4, 257, 256, 16, 64),
                 (4, 0, 256, 16, 64)):
        with pytest.raises(ValueError):
            mk.plan_variant(*args)


def test_sweep_inputs_and_floor():
    """The sweep's inputs at a small shape: every seventh doc empty, rows
    beyond a length zero, the mask of the lengths; the floor sums the whole
    contraction per doc."""
    q, g, lens, addmask = sweep_inputs("cpu", 4, nd=40, td=32, d=32, tq=8)
    assert q.shape == (32, 32) and g.shape == (40, 32, 32) and g.dtype == torch.bfloat16
    assert (lens[::7] == 0).all() and int(lens.max()) < 32 and int(lens[1:7].min()) >= 8
    valid = torch.arange(32)[None, :] < lens[:, None]
    assert (g[~valid] == 0).all() and (g[valid].abs().sum(dim=-1) > 0).all()
    assert ((addmask == 0) == valid).all() and (addmask[~valid] == NEG).all()
    lens2 = sweep_inputs("cpu", 4, nd=40, td=32, d=32, tq=8)[2]
    assert torch.equal(lens, lens2)  # lengths come from the numpy seed
    floor = one_big_dot_floor(q, g, block_bytes=4096)
    want = (g.float().reshape(40 * 32, 32) @ q.float().T).view(40, -1).sum(dim=1)
    # bf16 products (the library's output type) summed in f32.
    np.testing.assert_allclose(floor.numpy(), want.numpy(), rtol=0,
                               atol=0.02 * float(want.abs().max()))
    assert (floor[lens == 0] == 0).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_check(cuda, qflat, grid, arg, tq, **kw):
    """One launch of a variant on the card against its plain version there:
    rtol 1e-5, atol 1e-4; the probe 1e-3 of its largest |sum|. Returns the
    kernel's output on the host."""
    args = (_bf16(qflat).to(cuda), _bf16(grid).to(cuda), torch.from_numpy(arg).to(cuda), tq)
    before = mv.maxsim_variant_scores.launches
    got = maxsim_variant_scores(*args, **kw)
    torch.cuda.synchronize()
    assert mv.maxsim_variant_scores.launches == before + 1
    want = maxsim_variant_scores_reference(*args, **kw)
    if kw.get("dots_only"):
        atol, rtol = RTOL_DOTS_CARD * float(want.abs().max()), 0
    else:
        atol, rtol = ATOL, RTOL
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_n,tq,nd,td,d",
    [(4, 8, 8, 24, 128), (5, 32, 77, 40, 128), (9, 48, 130, 304, 128),
     (3, 20, 16, 8, 64), (2, 136, 33, 70, 32)],
)
@pytest.mark.parametrize(
    "name,mask,geometry,reduce,dots", SWEEP_VARIANTS, ids=[v[0] for v in SWEEP_VARIANTS]
)
def test_kernel_matches_plain_version(cuda, name, mask, geometry, reduce, dots,
                                      q_n, tq, nd, td, d):
    """Each variant of the kernel vs its plain version on the card: rtol
    1e-5, atol 1e-4; the probe 1e-3 of its largest |sum|."""
    qflat, grid, lens, addmask = _inputs(q_n * nd, q_n, tq, nd, td, d)
    _card_check(cuda, qflat, grid, addmask if mask == "additive" else lens, tq, mask=mask,
                geometry=geometry, reduce=reduce, dots_only=dots)


# (mask, reduce, dots_only) of each instance kind of the family.
KINDS = [("lens", "registers", False), ("lens", "shared", False),
         ("additive", "registers", False), ("additive", "shared", False),
         ("lens", "registers", True)]
KIND_IDS = ["lens-reg", "lens-shm", "add-reg", "add-shm", "dots"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", mv.ROWS)
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_kernel_64_docs_a_block_ragged_nd(cuda, kind, rows):
    """64 docs a block over 130 docs: the last block holds 2."""
    mask, reduce, dots = kind
    qflat, grid, lens, addmask = _inputs(21, 3, 32, 130, 100, 128)
    got = _card_check(cuda, qflat, grid, addmask if mask == "additive" else lens, 32,
                      mask=mask, geometry=(64, rows), reduce=reduce, dots_only=dots)
    if dots:
        assert (got[128:] == got[128]).all() and (got[:64] == got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("td", [70, 304])
@pytest.mark.parametrize("rows", mv.ROWS)
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_kernel_td_not_a_multiple_of_the_stage(cuda, kind, rows, td):
    """Td 70 and 304: a ragged last tile, and (at 128 rows a stage) a last
    stage of one tile; at Td 70 the additive mask's rows are padded to 72."""
    mask, reduce, dots = kind
    qflat, grid, lens, addmask = _inputs(22 + td, 5, 20, 37, td, 128)
    _card_check(cuda, qflat, grid, addmask if mask == "additive" else lens, 20,
                mask=mask, geometry=(8, rows), reduce=reduce, dots_only=dots)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", mv.ROWS)
@pytest.mark.parametrize("reduce", sorted(mv.REDUCES))
def test_kernel_additive_mask_need_not_be_a_prefix(cuda, reduce, rows):
    """On the card too the additive mask may hide any row; a doc with every
    row hidden scores 0."""
    q_n, tq, nd, td, d = 3, 16, 24, 150, 128
    qflat, grid, _, _ = _inputs(23, q_n, tq, nd, td, d)
    rng = np.random.default_rng(1)
    hidden = rng.random((nd, td)) < 0.4
    hidden[3] = True
    addmask = np.where(hidden, NEG, 0.0).astype(np.float32)
    got = _card_check(cuda, qflat, grid, addmask, tq, mask="additive", geometry=(4, rows),
                      reduce=reduce)
    assert (got[3] == 0).all()


@pytest.mark.cuda
def test_variant_smem_bytes_match_the_kernels_layout(cuda):
    """The Python plan's shared-memory bytes are the CUDA side's, for every
    instance kind of the family."""
    fn = mv._library().maxsim_variants_smem_bytes
    for mask, reduce, dots in KINDS:
        mask_code = mv._DOTS if dots else mv.MASKS[mask]
        side = 256 if mask == "additive" and not dots else 0
        scratch = reduce == "shared" and not dots
        for sub in (1, 2):
            for n in mk.WGMMA_COLS:
                for n_wg in (1, 2):
                    for panels in (1, 2, 4):
                        for stages in (2, 5, 8):
                            assert fn(n, n_wg, panels, stages, mask_code, mv.REDUCES[reduce],
                                      sub) == mk.smem_bytes(n, n_wg, panels, stages, False, sub,
                                                            side, scratch)
