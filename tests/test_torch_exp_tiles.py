"""The port's tile experiment (``tools/exp_block_tiles.py``) on the CPU.

At a small layout (4 row blocks of 8 tiles, 9 column blocks, d = 16) the
experiment's tile product is held against

* the numpy form of the reference formula of ``tools/exp_block_pallas.py``
  (window gather, ``einsum("tij,tjd->tid")``, sum over each row block's
  tiles), f32 and bf16 within 1e-5 * max(1, max|ref|) (exact products,
  another f32 summation order; a window left unrounded under bf16 tiles
  is shown to fail that limit), and
* the Pallas kernel itself in interpret mode: the same arrays handed to
  ``gcn_recommendation_tpu.ops.block_spmm.tile_matvec`` in a hand-built
  ``TileDeviceArrays`` at 1 tile and at 8 tiles per grid step, same
  tolerances.

The Pallas kernels of the tool are the bodies of that kernel at TB = 1
with a row id per tile and at TB = 8 with a row id per step.

The experiment's tiles are full, so ``layout="auto"`` gives them the dense
layout; the last tests force the compressed layout on the same tiles and
hold it to the same references, and check that the dense kernel's host
plan is the same at 1 and at 8 tiles per step.
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.ops import block_spmm as jbs
from gcn_recommendation_tpu_torch.ops import block_spmm
from gcn_recommendation_tpu_torch.tools import exp_block_tiles as exp
from gcn_recommendation_tpu_torch.tools import exp_tile_variants as exp_variants
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

N_BLOCKS, D, M, R_BLOCKS = 9, 16, 8, 4
CASES = [(1, "float32"), (1, "bfloat16"), (8, "float32"), (8, "bfloat16")]


@pytest.fixture(scope="module")
def layout():
    return exp.make_layout(seed=0, n_blocks=N_BLOCKS, d=D, m=M, r_blocks=R_BLOCKS)


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _numpy_reference(layout, dtype):
    """The tool's reference formula in numpy, f32 accumulation."""
    t = layout.num_tiles
    a, e = layout.tile_a, layout.e
    if dtype == "bfloat16":
        a, e = _bf16_round(a), _bf16_round(e)
    g = e.reshape(N_BLOCKS, 128 * D)[layout.tile_col].reshape(t, 128, D)
    prod = np.einsum("tij,tjd->tid", a, g, dtype=np.float32)
    return prod.reshape(R_BLOCKS, M, 128, D).sum(1).reshape(R_BLOCKS * 128, D)


def _tol(dtype, ref):
    scale = float(np.abs(ref).max())
    return exp.RTOL * max(1.0, scale)


def test_defaults_are_the_experiments_layout():
    assert (exp.N_BLOCKS, exp.D, exp.M, exp.R_BLOCKS, exp.CHAIN) == (564, 64, 16, 384, 30)
    assert exp.M * exp.R_BLOCKS == 6144


def test_layout_draws_in_the_experiments_order(layout):
    rng = np.random.default_rng(0)
    t = M * R_BLOCKS
    e = rng.standard_normal((N_BLOCKS * 128, D)).astype(np.float32)
    tile_a = (rng.standard_normal((t, 128, 128)) * 0.01).astype(np.float32)
    tile_col = rng.integers(0, N_BLOCKS, t).astype(np.int32)
    np.testing.assert_array_equal(layout.e, e)
    np.testing.assert_array_equal(layout.tile_a, tile_a)
    np.testing.assert_array_equal(layout.tile_col, tile_col)
    assert layout.tile_col.dtype == np.int32 and (layout.tile_a != 0).all()
    assert (layout.num_tiles, layout.d, layout.m, layout.r_blocks) == (t, D, M, R_BLOCKS)
    with pytest.raises(ValueError, match="r_blocks must be <= n_blocks"):
        exp.make_layout(0, n_blocks=2, d=4, m=1, r_blocks=3)


@pytest.mark.parametrize("tb", [1, 8])
def test_device_tiles_give_row_ids_per_tile_or_per_step(layout, tb):
    tiles = exp.device_tiles(layout, tb, torch.float32, "cpu")
    assert tiles.tiles_per_step == tb and tiles.n_row_blocks == R_BLOCKS
    assert tiles.num_tiles == M * R_BLOCKS
    steps = M // tb
    np.testing.assert_array_equal(tiles.step_row.numpy(), np.repeat(np.arange(R_BLOCKS), steps))
    np.testing.assert_array_equal(tiles.row_step_ptr.numpy(), np.arange(R_BLOCKS + 1) * steps)
    assert tiles.step_row.dtype == tiles.row_step_ptr.dtype == tiles.tile_col.dtype == torch.int32
    assert tiles.tile_gather_idx is None and tiles.row_block_nodes is None
    with pytest.raises(ValueError, match="do not split"):
        exp.device_tiles(layout, 3, torch.float32, "cpu")


@pytest.mark.parametrize("tb,dtype", CASES)
def test_tile_product_matches_the_reference_formula(layout, tb, dtype):
    tiles = exp.device_tiles(layout, tb, getattr(torch, dtype), "cpu")
    e = torch.from_numpy(layout.e)
    ref = _numpy_reference(layout, dtype)
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(e, tiles).numpy()
    assert block_spmm.tile_matvec.launches == before  # CPU: the plain version
    assert out.shape == (R_BLOCKS * 128, D) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(dtype, ref))
    # the experiment's own plain version is the same formula
    np.testing.assert_allclose(exp.reference(e, tiles, M).numpy(), ref, rtol=0,
                               atol=_tol(dtype, ref))


@pytest.mark.parametrize("tb,dtype", CASES)
def test_tile_product_matches_the_pallas_kernel_in_interpret_mode(layout, tb, dtype):
    """The same arrays through the JAX package's Pallas kernel: a row id
    per tile at TB = 1 (the single-tile kernel's grid), a row id per step
    at TB = 8 (the batched kernel's)."""
    tiles = exp.device_tiles(layout, tb, getattr(torch, dtype), "cpu")
    jt = jbs.TileDeviceArrays(
        tile_a=jnp.asarray(layout.tile_a, dtype=getattr(jnp, dtype)),
        tile_col=jnp.asarray(layout.tile_col),
        step_row=jnp.asarray(np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M // tb)),
        tile_gather_idx=jnp.zeros((0,), jnp.int32),            # not read by tile_matvec
        row_block_nodes=jnp.zeros((R_BLOCKS, 128), jnp.int32),  # carries R only
    )
    assert jt.tile_a.shape[0] // jt.step_row.shape[0] == tb
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(layout.e), jt))
    out = block_spmm.tile_matvec(torch.from_numpy(layout.e), tiles).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(dtype, ref))


def test_one_tile_per_step_equals_eight(layout):
    e = torch.from_numpy(layout.e)
    one = block_spmm.tile_matvec(e, exp.device_tiles(layout, 1, torch.float32, "cpu"))
    eight = block_spmm.tile_matvec(e, exp.device_tiles(layout, 8, torch.float32, "cpu"))
    scale = float(one.abs().max())
    assert float((one - eight).abs().max()) <= exp.RTOL * max(1.0, scale)
    assert scale > 0.5  # values reach order 1: the tolerance scales with them


@pytest.mark.parametrize("tb", [1, 8])
def test_chain_equals_a_numpy_chain(layout, tb):
    tiles = exp.device_tiles(layout, tb, torch.float32, "cpu")
    got = float(exp.chain(torch.from_numpy(layout.e), tiles, steps=4))
    c = layout.e.copy()
    pad = np.zeros(((N_BLOCKS - R_BLOCKS) * 128, D), np.float32)
    for _ in range(4):
        g = c.reshape(N_BLOCKS, 128 * D)[layout.tile_col].reshape(-1, 128, D)
        o = np.einsum("tij,tjd->tid", layout.tile_a, g).reshape(R_BLOCKS, M, 128, D).sum(1)
        c = np.concatenate([o.reshape(-1, D), pad]) * np.float32(1e-2) + c * np.float32(0.99)
    want = float(c.astype(np.float64).sum())
    # f32 sums over 18,432 values of order 1
    assert got == pytest.approx(want, abs=1e-2)
    assert exp.moved_bytes(tiles, D) == M * R_BLOCKS * (128 * 128 * 4 + 128 * D * 4)


def test_run_case_reports_and_refuses(layout, monkeypatch):
    r = exp.run_case(layout, 8, torch.bfloat16, "cpu", chain_steps=2)
    assert r["tiles"] == M * R_BLOCKS and r["tiles_per_step"] == 8 and r["dtype"] == "bfloat16"
    assert r["max_abs_err"] <= r["tol"] == pytest.approx(exp.RTOL * max(1.0, r["scale"]))
    assert r["ms"] > 0 and r["ns_per_tile"] == pytest.approx(r["ms"] * 1e6 / r["tiles"])
    assert r["clock"] == "host clock (CPU)" and np.isfinite(r["chain_sum"])
    monkeypatch.setattr(exp, "reference", lambda e, tiles, m: torch.ones(R_BLOCKS * 128, D))
    with pytest.raises(RuntimeError, match="max abs diff"):
        exp.run_case(layout, 1, torch.float32, "cpu", chain_steps=1)


@pytest.mark.parametrize("tb", [1, 8])
def test_bf16_limit_refuses_an_unrounded_window(layout, tb, monkeypatch):
    """A product of bf16 tiles with the f32 window (what a kernel that
    forgot to round the window computes) is far outside the limit that
    the rounded product meets."""
    tiles = exp.device_tiles(layout, tb, torch.bfloat16, "cpu")
    e = torch.from_numpy(layout.e)
    ref = exp.reference(e, tiles, M)
    tol = _tol("bfloat16", ref.numpy())
    unrounded = exp.reference(e, tiles, M, round_window=False)
    assert float((block_spmm.tile_matvec(e, tiles) - ref).abs().max()) <= tol
    assert float((unrounded - ref).abs().max()) > 10 * tol
    monkeypatch.setattr(exp, "tile_matvec", lambda c, t: exp.reference(c, t, M, False))
    with pytest.raises(RuntimeError, match="max abs diff"):
        exp.run_case(layout, tb, torch.bfloat16, "cpu", chain_steps=1)


@pytest.mark.parametrize("tb,dtype", [(1, "float32"), (8, "float32"), (1, "bfloat16")])
def test_cli_runs_on_the_cpu(layout, monkeypatch, tb, dtype):
    # the command line always runs the experiment's full layout; here it gets the small one
    monkeypatch.setattr(exp, "make_layout", lambda seed: layout)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = exp.main(["--device", "cpu", "--tiles_per_step", str(tb), "--dtype", dtype])
    text = out.getvalue()
    assert rc == 0 and f"[TB={tb} {dtype}] max err vs reference" in text
    assert "ms per application" in text and "ns/tile" in text and "GB/s" in text


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.main([])


# ------------------------------------------------------- tiles from raw arrays


def test_tiles_from_arrays_takes_row_ids_per_tile_at_any_step_size(layout):
    per_tile = np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M)
    a = block_spmm.tiles_from_arrays(layout.tile_a, layout.tile_col, per_tile, 8, R_BLOCKS,
                                     device="cpu")
    b = exp.device_tiles(layout, 8, torch.float32, "cpu")
    assert torch.equal(a.step_row, b.step_row) and torch.equal(a.row_step_ptr, b.row_step_ptr)
    # a row block without tiles owns no step and comes out zero
    c = block_spmm.tiles_from_arrays(layout.tile_a[:8], layout.tile_col[:8],
                                     np.full(8, 2, np.int32), 1, 4, device="cpu")
    np.testing.assert_array_equal(c.row_step_ptr.numpy(), [0, 0, 0, 8, 8])
    out = block_spmm.tile_matvec(torch.from_numpy(layout.e), c)
    assert out.shape == (4 * 128, D) and not out[: 2 * 128].any() and out[2 * 128 : 3 * 128].any()


def test_tiles_from_arrays_refuses_bad_layouts(layout):
    a, col = layout.tile_a, layout.tile_col
    rows = np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M)
    for kw, msg in [
        (dict(tile_a=a[:, :64]), "want"),
        (dict(tile_col=col[:-1]), "want"),
        (dict(tiles_per_step=5), "do not split"),
        (dict(rows=rows[:-1]), "one id per tile"),
        (dict(rows=rows[::-1].copy()), "sorted"),
        (dict(rows=rows + 1), "sorted and in"),
        (dict(rows=np.roll(rows, 1), tiles_per_step=8), "different row blocks"),
    ]:
        args = dict(tile_a=a, tile_col=col, rows=rows, tiles_per_step=1,
                    n_row_blocks=R_BLOCKS, device="cpu")
        args.update(kw)
        with pytest.raises(ValueError, match=msg):
            block_spmm.tiles_from_arrays(**args)


def test_tiles_without_a_node_map_refuse_the_graph_product(layout):
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph

    g = to_device_graph(synthetic_bundle(40, 30, 4, seed=0).graph, device="cpu")
    tiles = exp.device_tiles(layout, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no node map"):
        propagate(torch.zeros((74, D)), block_spmm.TiledDeviceGraph(base=g, tiles=tiles))


# ------------------------------------------------------------ the two layouts


def _layout_tiles(layout, tb, dtype, which):
    rows = np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M // tb)
    return block_spmm.tiles_from_arrays(
        layout.tile_a, layout.tile_col, rows, tb, R_BLOCKS, tile_dtype=getattr(torch, dtype),
        device="cpu", layout=which)


def test_layout_auto_picks_dense_on_the_experiments_tiles(layout):
    tiles = exp.device_tiles(layout, 1, torch.float32, "cpu")
    assert tiles.layout == "dense" and tiles.edge_w is None and tiles.plan is not None
    assert tiles.tile_a.shape == (M * R_BLOCKS, 128, 128)
    # the same geometry, thinned to a graph partition's fill, goes the other way
    thin = layout.tile_a * (np.random.default_rng(1).random(layout.tile_a.shape) < 0.004)
    rows = np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M)
    auto = block_spmm.tiles_from_arrays(thin, layout.tile_col, rows, 1, R_BLOCKS, device="cpu")
    assert auto.layout == "compressed" and auto.tile_a is None
    assert auto.edge_w.numel() == np.count_nonzero(thin)
    with pytest.raises(ValueError, match="layout"):
        block_spmm.tiles_from_arrays(thin, layout.tile_col, rows, 1, R_BLOCKS, device="cpu",
                                     layout="sparse")


@pytest.mark.parametrize("tb,dtype", CASES)
def test_compressed_layout_matches_the_reference_formula(layout, tb, dtype):
    tiles = _layout_tiles(layout, tb, dtype, "compressed")
    assert tiles.layout == "compressed" and tiles.tile_a is None
    assert tiles.tiles_per_step == tb and tiles.edge_w.numel() == layout.tile_a.size
    ref = _numpy_reference(layout, dtype)
    out = block_spmm.tile_matvec(torch.from_numpy(layout.e), tiles).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(dtype, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_layout_matches_the_pallas_kernel_in_interpret_mode(layout, dtype):
    jt = jbs.TileDeviceArrays(
        tile_a=jnp.asarray(layout.tile_a, dtype=getattr(jnp, dtype)),
        tile_col=jnp.asarray(layout.tile_col),
        step_row=jnp.asarray(np.repeat(np.arange(R_BLOCKS, dtype=np.int32), M)),
        tile_gather_idx=jnp.zeros((0,), jnp.int32),
        row_block_nodes=jnp.zeros((R_BLOCKS, 128), jnp.int32),
    )
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(layout.e), jt))
    out = block_spmm.tile_matvec(torch.from_numpy(layout.e),
                                 _layout_tiles(layout, 1, dtype, "compressed")).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(dtype, ref))


@pytest.mark.parametrize("which", ["dense", "compressed"])
def test_one_tile_per_step_and_eight_hold_the_same_arrays(layout, which):
    """The step size is a property of the TPU grid: the arrays either CUDA
    kernel reads (the dense kernel's plan, the compressed edges) do not
    depend on it, so one tile per step and eight give the same bits."""
    one, eight = (_layout_tiles(layout, tb, "float32", which) for tb in (1, 8))
    assert (one.tiles_per_step, eight.tiles_per_step) == (1, 8)
    if which == "dense":
        for f in dataclasses.fields(one.plan):
            a, b = getattr(one.plan, f.name), getattr(eight.plan, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
        p = one.plan
        assert p.n_blocks == min(M * R_BLOCKS, block_spmm.DENSE_BLOCKS_PER_SM
                                 * block_spmm.DEFAULT_SM_COUNT)
        assert torch.equal(p.list_tile, torch.arange(M * R_BLOCKS, dtype=torch.int32))
        seg = p.segments.numpy()
        assert seg[0, 0] == 0 and seg[-1, 1] == M * R_BLOCKS
        np.testing.assert_array_equal(seg[1:, 0], seg[:-1, 1])  # every tile once, in order
    else:
        for name in ("edge_row_ptr", "edge_src", "edge_w"):
            assert torch.equal(getattr(one, name), getattr(eight, name)), name
    e = torch.from_numpy(layout.e)
    assert torch.equal(block_spmm.tile_matvec(e, one), block_spmm.tile_matvec(e, eight))


# ------------------------------------------------- the kernel-variant experiment


@pytest.mark.parametrize("name", sorted(exp_variants.VARIANTS))
def test_every_kernel_variant_still_applies_to_the_source(name):
    """The variants are text edits of ``csrc/tile_spmm.cu``: each must find
    its lines there, or the experiment would time the unchanged kernel."""
    from gcn_recommendation_tpu_torch.kernels import _build

    with open(_build.source_path("tile_spmm")) as f:
        source = f.read()
    edits = exp_variants.VARIANTS[name]
    out = exp_variants.variant_source(source, edits)
    assert (out == source) == (name == "base")
    for old, new in edits:
        assert old not in out or (new and old in new)
    with pytest.raises(ValueError, match="no longer holds"):
        exp_variants.variant_source(source, [("not a line of the kernel", "")])


def test_kernel_variant_experiment_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the experiment would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_variants.main()
