"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import block_spmm, quant, spmm, topk
from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.tools import exp_block_tiles
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import profiling

from ell_order import kernel_order, sum_order_bound

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bundle():
    # 1,730 nodes: the last 128-row column block is ragged
    return synthetic_bundle(1000, 700, 30, mean_degree=20.0, core=4, seed=1)


def test_kernel_matches_plain_on_card(card):
    gen = torch.Generator(device=card).manual_seed(0)
    for n, d in ((20_000, 64), (1_000, 48), (7, 200)):
        x = torch.randn((n, d), generator=gen, device=card)
        before = quant.quantize_rows_int8.launches
        q_k, s_k = quant.quantize_rows_int8(x, seed=3)
        assert quant.quantize_rows_int8.launches == before + 1
        q_p, s_p = quant._quantize_rows_int8_reference(x, seed=3)
        torch.cuda.synchronize()
        assert torch.equal(q_k, q_p) and torch.equal(s_k, s_p)


def _v1(x, seed):
    """The first version of the quantizer kernel, through its entry point."""
    from gcn_recommendation_tpu_torch.kernels._build import load_library

    q, s = quant._empty_out(x)
    err = load_library("quant_int8").quantize_rows_int8_launch_v1(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), x.shape[0], x.shape[1], seed,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return q, s


@pytest.mark.parametrize("n,d", [
    (20_000, 64), (1_024, 64), (1_000, 48), (37, 50), (8, 64), (32, 64), (64, 48), (1, 64),
    (9, 4), (9, 8), (9, 16), (33, 32), (7, 200), (100, 256), (100, 512), (5, 516), (3, 1000),
])
def test_quantizer_modes_match_plain_and_v1_on_card(card, n, d):
    """New kernel == first kernel == plain (stochastic), new kernel == plain
    (nearest), bit for bit: every lane-group width, two and four float4s a
    lane, the warp-per-row path (d % 4 != 0, d > 512), ragged row counts."""
    x = torch.randn((n, d), generator=torch.Generator(device=card).manual_seed(n + d),
                    device=card) * 0.05
    x[0] = 0.0
    before = (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches)
    q_k, s_k = quant.quantize_rows_int8(x, seed=9)
    q_n, s_n = quant.quantize_users_int8(x)
    assert (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches) == (
        before[0] + 1, before[1] + 1)
    q_1, s_1 = _v1(x, 9)
    q_p, s_p = quant._quantize_rows_int8_reference(x, seed=9)
    q_r, s_r = quant._quantize_users_int8_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(q_k, q_p) and torch.equal(s_k, s_p)
    assert torch.equal(q_1, q_p) and torch.equal(s_1, s_p)
    assert torch.equal(q_n, q_r) and torch.equal(s_n, s_r)


def test_quantizer_out_buffers_and_odd_bases_on_card(card):
    """``out=`` is written in place (strided rows into a padded buffer, the
    padding untouched); a base that is not 16-byte aligned takes the
    warp-per-row path and gives the same bits; what the wrapper cannot
    take raises."""
    x = torch.randn((1000, 50), device=card)
    codes, scales = quant.alloc_user_buffers(1000, 50, card)
    q, s = quant.quantize_users_int8(x, out=(codes[:1000, :50], scales))
    want = quant._quantize_users_int8_reference(x)
    assert q.data_ptr() == codes.data_ptr() and s is scales
    assert torch.equal(q, want[0]) and torch.equal(s, want[1]) and not codes[:, 50:].any()
    x64 = torch.randn((1000, 64), device=card)
    codes, scales = quant.alloc_user_buffers(1000, 68, card)  # rows 72 bytes apart
    q, s = quant.quantize_rows_int8(x64, seed=4, out=(codes[:1000, :64], scales))
    want = quant._quantize_rows_int8_reference(x64, seed=4)
    assert torch.equal(q, want[0]) and torch.equal(s, want[1]) and not codes[:, 64:].any()
    shifted = torch.randn(1000 * 64 + 1, device=card)[1:].view(1000, 64)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    q, s = quant.quantize_rows_int8(shifted, seed=4)
    want = quant._quantize_rows_int8_reference(shifted, seed=4)
    assert torch.equal(q, want[0]) and torch.equal(s, want[1])
    with pytest.raises(ValueError, match="contiguous 2-D float32"):
        quant.quantize_users_int8(x.t())
    with pytest.raises(ValueError, match="contiguous 2-D float32"):
        quant.quantize_rows_int8(x.double())
    with pytest.raises(ValueError, match="out= wants"):
        quant.quantize_users_int8(x, out=(codes[:1000, :50].cpu(), scales))
    # empty inputs launch nothing and return empty outputs
    before = quant.quantize_rows_int8.launches
    q, s = quant.quantize_rows_int8(torch.empty((0, 64), device=card))
    assert q.shape == (0, 64) and s.shape == (0, 1)
    assert quant.quantize_rows_int8.launches == before


@pytest.mark.parametrize("b,i,d", [(8, 700, 64), (32, 700, 64), (64, 301, 48), (1024, 301, 50)])
def test_int8_request_launches_the_nearest_mode_once_on_card(card, b, i, d):
    """``quantized_topk_scores`` on the card: one launch for the users, the
    same scores as its plain lines on the CPU."""
    gen = torch.Generator().manual_seed(b + d)
    u = torch.randn((b, d), generator=gen)
    items = torch.randn((i, d), generator=gen)
    filt = torch.full((b, 4), i, dtype=torch.int64)
    filt[:, :2] = torch.randint(0, i, (b, 2), generator=gen)
    item_q, item_scale = quant.quantize_rows_int8(items)  # the plain version, on the CPU
    v_c, i_c = quant.quantized_topk_scores(u, item_q, item_scale, filt, 10)
    before = (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches)
    table = quant.pad_int8_table(item_q.to(card))
    buffers = quant.alloc_user_buffers(b, d, card)
    for _ in range(2):  # the kept buffers serve a second request
        v_k, i_k = quant.quantized_topk_scores(
            u.to(card), table, item_scale.to(card), filt.to(card), 10, user_buffers=buffers)
        torch.cuda.synchronize()
        # integer products are exact: only the f32 rescale may round apart
        np.testing.assert_allclose(v_k.cpu().numpy(), v_c.numpy(), rtol=1e-6)
        assert (i_k.cpu() != i_c).float().mean().item() < 0.01
    assert (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches) == (
        before[0], before[1] + 2)


def test_retriever_on_another_thread_launches_on_its_device_on_card(card, bundle):
    """The daemon's dispatcher thread: a thread of its own, grad mode and
    current device per thread.  An int8 request from it launches the
    nearest mode once and equals the main thread's answer."""
    import threading

    cfg = Config(embedding_dim=32, n_layers=2)
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                              device=card)
    params = m.init(torch.Generator().manual_seed(0))
    r = Retriever.from_params(m, params, bundle, quantize=True)
    users = np.unique(bundle.train.user_idx)[:16]
    want = r.recommend(users, k=10)
    got, before = {}, quant.quantize_users_int8.launches

    def work():
        got["grad"] = torch.is_grad_enabled()
        got["answer"] = r.recommend(users, k=10)
        got["rebuilt"] = Retriever.from_params(m, params, bundle, quantize=True).recommend(
            users, k=10)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and got["grad"] is True  # a new thread starts with grad enabled
    assert quant.quantize_users_int8.launches == before + 2
    for name in ("answer", "rebuilt"):
        np.testing.assert_array_equal(got[name][1], want[1])
        np.testing.assert_array_equal(got[name][0], want[0])


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.float32, 48), (torch.float32, 16), (torch.bfloat16, 32),
])
def test_tile_kernel_matches_plain_on_card(card, bundle, dtype, d):
    g = bundle.graph
    part = partition_tiles(g, min_fill=16, tiles_per_step=8)
    assert g.num_nodes % 128 and part is not None
    tiles = block_spmm.to_device_tiles(part, tile_dtype=dtype, device=card)
    e = torch.randn((g.num_nodes, d), generator=torch.Generator(device=card).manual_seed(d),
                    device=card)
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(e, tiles)
    assert block_spmm.tile_matvec.launches == before + 1
    ref = block_spmm._tile_matvec_reference(e, tiles)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # bf16: the plain version rounds the window as the kernel does, so products are exact too
    tol = 1e-5 if dtype == torch.float32 else 1e-5 * max(1.0, ref.abs().max().item())
    assert err <= tol, (err, tol)


def test_tile_kernel_refuses_what_it_cannot_take(card, bundle):
    part = partition_tiles(bundle.graph, min_fill=16, tiles_per_step=8)
    n = bundle.graph.num_nodes
    # the widths and the alignment: test_each_layouts_wrapper_refuses_what_its_kernel_cannot_take
    cpu_tiles = block_spmm.to_device_tiles(part, device="cpu")
    with pytest.raises(ValueError, match="tiles on cpu"):
        block_spmm.tile_matvec(torch.zeros((n, 8), device=card), cpu_tiles)


@pytest.mark.parametrize("layout,d", [("auto", 32), ("compressed", 256), ("dense", 256)])
def test_tile_gradient_matches_ell_on_card(card, bundle, layout, d):
    g = bundle.graph
    part = partition_tiles(g, min_fill=16, tiles_per_step=8)
    res, full = to_device_graph(part.residual, device=card), to_device_graph(g, device=card)
    tiles = block_spmm.to_device_tiles(part, device=card, layout=layout)
    x = torch.randn((g.num_nodes, d), device=card).requires_grad_(True)
    tiled = block_spmm.TiledDeviceGraph(base=res, tiles=tiles)
    (g_tile,) = torch.autograd.grad((propagate(x, tiled) ** 2).sum(), x)
    (g_ell,) = torch.autograd.grad((propagate(x, full) ** 2).sum(), x)
    assert (g_tile - g_ell).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d,layers", [(32, 3), (256, 4)])  # 256 x 4: BASELINE configs[4]
def test_train_step_launches_the_kernel_twice_per_layer(card, bundle, d, layers):
    losses = {}
    for tile in (True, False):
        cfg = Config(embedding_dim=d, n_layers=layers, batch_size=512, tile_spmm=tile,
                     tile_min_fill=16)
        m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=card)
        m.init(torch.Generator().manual_seed(0))
        tr = Trainer(cfg, m, bundle)
        rng = np.random.default_rng(0)
        rows = torch.from_numpy(rng.integers(0, len(bundle.train), 512)).to(card)
        neg = torch.from_numpy(rng.integers(0, bundle.num_items, 512)).to(card)
        if tile:  # layout auto: a graph partition runs the compressed kernel
            assert tr.graph.tiles.layout == "compressed" and tr.graph.tiles.tile_a is None
        before = block_spmm.tile_matvec.launches
        losses[tile] = tr.train_step(tr.train_users[rows], tr.train_items[rows], neg).item()
        assert block_spmm.tile_matvec.launches - before == (2 * layers if tile else 0)
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


@pytest.mark.parametrize("layout", ["compressed", "dense"])
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.bfloat16, 64), (torch.float32, 48), (torch.bfloat16, 48),
    (torch.float32, 4), (torch.bfloat16, 20), (torch.float32, 128), (torch.bfloat16, 128),
    # past one 128-column slab, and widths that are no multiple of 4 (the
    # wrapper pads them with zero columns)
    *((dt, w) for w in (4, 50, 132, 200, 256, 1, 6, 130)
      for dt in (torch.float32, torch.bfloat16) if (dt, w) != (torch.float32, 4)),
])
def test_each_layouts_kernel_matches_plain_on_card(card, bundle, layout, dtype, d):
    g = bundle.graph
    part = partition_tiles(g, min_fill=16, tiles_per_step=8)
    assert g.num_nodes % 128 and part is not None  # ragged last window
    tiles = block_spmm.to_device_tiles(part, tile_dtype=dtype, device=card, layout=layout)
    assert tiles.layout == layout and (tiles.tile_a is None) == (layout == "compressed")
    e = torch.randn((g.num_nodes, d), generator=torch.Generator(device=card).manual_seed(d),
                    device=card)
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(e, tiles)
    assert block_spmm.tile_matvec.launches == before + 1
    assert out.shape == (part.n_row_blocks * 128, d) and out.is_contiguous()
    ref = block_spmm._tile_matvec_reference(e, tiles)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 1e-5 * max(1.0, ref.abs().max().item())
    assert err <= tol, (err, tol)
    # deterministic: no atomics in either kernel
    assert torch.equal(out, block_spmm.tile_matvec(e, tiles))


def test_layouts_agree_with_each_other_on_card(card, bundle):
    part = partition_tiles(bundle.graph, min_fill=16, tiles_per_step=8)
    e = torch.randn((bundle.graph.num_nodes, 64), device=card)
    outs = [block_spmm.tile_matvec(e, block_spmm.to_device_tiles(part, device=card, layout=lay))
            for lay in ("compressed", "dense")]
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("layout", ["compressed", "dense"])
def test_bf16_kernels_round_the_window_on_card(card, layout):
    """bf16 tiles meet the embedding rounded to bf16: the product with the
    window left in f32 lies far outside the limit that the kernel meets."""
    lay = exp_block_tiles.make_layout(seed=2, n_blocks=40, d=64, m=16, r_blocks=24)
    rows = np.repeat(np.arange(lay.r_blocks, dtype=np.int32), lay.m)
    tiles = block_spmm.tiles_from_arrays(lay.tile_a, lay.tile_col, rows, 1, lay.r_blocks,
                                         tile_dtype=torch.bfloat16, device=card, layout=layout)
    e = torch.from_numpy(lay.e).to(card)
    out = block_spmm.tile_matvec(e, tiles)
    ref = block_spmm._tile_matvec_reference(e, tiles)
    key = "tile_a" if layout == "dense" else "edge_w"
    widened = dataclasses.replace(tiles, **{key: tiles.values.float()})
    unrounded = block_spmm._tile_matvec_reference(e, widened)  # same values, f32 window
    torch.cuda.synchronize()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol
    assert (out - unrounded).abs().max().item() > 10 * tol


@pytest.mark.parametrize("layout", ["compressed", "dense"])
def test_each_layouts_wrapper_refuses_what_its_kernel_cannot_take(card, bundle, layout):
    part = partition_tiles(bundle.graph, min_fill=16, tiles_per_step=8)
    tiles = block_spmm.to_device_tiles(part, device=card, layout=layout)
    n = bundle.graph.num_nodes
    # every width d >= 1 is taken (test_each_layouts_kernel_matches_plain_on_card)
    with pytest.raises(ValueError, match="d >= 1"):
        block_spmm.tile_matvec(torch.zeros((n, 0), device=card), tiles)
    with pytest.raises(ValueError, match="aligned"):
        block_spmm.tile_matvec(torch.zeros((n * 8 + 1,), device=card)[1:].view(n, 8), tiles)
    cpu_tiles = block_spmm.to_device_tiles(part, device="cpu", layout=layout)
    with pytest.raises(ValueError, match="tiles on cpu"):
        block_spmm.tile_matvec(torch.zeros((n, 8), device=card), cpu_tiles)
    key = "tile_a" if layout == "dense" else "edge_w"
    strided = torch.cat([tiles.values, tiles.values], dim=-1)[..., :: 2]
    with pytest.raises(ValueError, match="contiguous"):
        block_spmm.tile_matvec(torch.zeros((n, 8), device=card),
                               dataclasses.replace(tiles, **{key: strided}))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        block_spmm.tile_matvec(torch.zeros((n, 8), device=card),
                               dataclasses.replace(tiles, **{key: tiles.values.half()}))
    if layout == "dense":  # a column block past the table
        with pytest.raises(ValueError, match="past the"):
            block_spmm.tile_matvec(torch.zeros((128, 8), device=card), tiles)
    # a transposed (non-contiguous) embedding is copied, not refused: autograd hands such in
    e = torch.randn((8, n), device=card).t()
    assert not e.is_contiguous()
    ref = block_spmm._tile_matvec_reference(e, tiles)
    assert (block_spmm.tile_matvec(e, tiles) - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("tb,dtype", [(1, torch.float32), (1, torch.bfloat16),
                                      (8, torch.float32)])
def test_exp_tiles_kernel_matches_plain_on_card(card, tb, dtype):
    # the experiment's width (d = 64) and tiles per row block at fewer blocks
    layout = exp_block_tiles.make_layout(seed=0, n_blocks=40, d=64, m=16, r_blocks=24)
    before = block_spmm.tile_matvec.launches
    assert exp_block_tiles.device_tiles(layout, tb, dtype, card).layout == "dense"  # auto
    r = exp_block_tiles.run_case(layout, tb, dtype, card, chain_steps=3)
    assert block_spmm.tile_matvec.launches - before == 1 + 2 * 3
    assert r["max_abs_err"] <= r["tol"] and r["clock"] == "cuda events" and r["ms"] > 0


def test_exp_tiles_one_tile_per_step_equals_eight_on_card(card):
    layout = exp_block_tiles.make_layout(seed=1, n_blocks=40, d=64, m=16, r_blocks=24)
    e = torch.from_numpy(layout.e).to(card)
    one = block_spmm.tile_matvec(e, exp_block_tiles.device_tiles(layout, 1, device=card))
    eight = block_spmm.tile_matvec(e, exp_block_tiles.device_tiles(layout, 8, device=card))
    torch.cuda.synchronize()
    # the dense kernel's ranges are cut in tiles, not in steps: the same bits
    assert torch.equal(one, eight) and one.abs().max().item() > 0.5


@pytest.mark.parametrize("mult", [1, 8])
def test_fusion_step_and_serving_on_card(card, bundle, mult):
    """A LightGCN_Fusion step through the tile kernel equals the ELL step,
    padded or not; the content buffer stays; the int8 catalog launches the
    quantizer once."""
    content = np.random.default_rng(7).standard_normal((bundle.num_items, 32)).astype(np.float32)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, len(bundle.train), 512)).to(card)
    neg = torch.from_numpy(rng.integers(0, bundle.num_items, 512)).to(card)
    losses, params = {}, None
    for tile in (True, False):
        cfg = Config(embedding_dim=32, n_layers=3, batch_size=512, tile_spmm=tile,
                     tile_min_fill=16, model_name="LightGCN_Fusion")
        m = get_model("LightGCN_Fusion")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                         cfg, pretrained_item_emb=content, device=card)
        m.set_row_multiple(mult)
        if params is None:
            params = {k: v.clone() for k, v in m.init(torch.Generator().manual_seed(0)).items()}
        else:
            m.load_params(params)
        tr = Trainer(cfg, m, bundle)
        before = block_spmm.tile_matvec.launches
        losses[tile] = tr.train_step(tr.train_users[rows], tr.train_items[rows], neg).item()
        assert block_spmm.tile_matvec.launches - before == (6 if tile else 0)
        assert m.item_content_embedding.grad is None
        assert torch.equal(m.params()["item_content_embedding"][: bundle.num_items].cpu(),
                           torch.from_numpy(content))
        assert not torch.equal(m.params()["fusion_kernel"], params["fusion_kernel"])
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    before = quant.quantize_rows_int8.launches
    r = Retriever.from_params(m, m.params(), bundle, quantize=True)
    assert quant.quantize_rows_int8.launches == before + 1
    v, i = r.recommend(np.unique(bundle.train.user_idx)[:16], k=10)
    assert v.shape == (16, 10) and np.isfinite(v).all() and i.max() < bundle.num_items


@pytest.mark.parametrize("n,d", [(20_000, 64), (1_000, 48), (37, 50)])
def test_quantizer_row_offset_matches_plain_on_card(card, n, d):
    """The kernel's ``row_offset``: stochastic codes of a shard that starts
    at a global row equal the plain version's and the whole table's rows;
    the nearest mode draws no bits, so the offset changes nothing."""
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((n, d), generator=gen, device=card)
    q_all, s_all = quant.quantize_rows_int8(x, seed=9)
    half = n // 2
    q_k, s_k = quant.quantize_rows_int8(x[half:].contiguous(), seed=9, row_offset=half)
    q_p, s_p = quant._quantize_rows_int8_reference(x[half:], seed=9, row_offset=half)
    torch.cuda.synchronize()
    assert torch.equal(q_k, q_p) and torch.equal(s_k, s_p)
    assert torch.equal(q_k, q_all[half:]) and torch.equal(s_k, s_all[half:])
    q_n, s_n = quant._launch_quantizer(quant.quantize_users_int8, x, quant._MODE_NEAREST, 0,
                                       None, row_offset=half)
    q_r, s_r = quant._quantize_users_int8_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(q_n, q_r) and torch.equal(s_n, s_r)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_world_of_one_sharded_retriever_on_card(card, bundle, quantize):
    """A world of one over NCCL, mesh (1, 1): the sharded retriever answers
    as the single-device one, with the int8 catalog bit-equal and the
    quantizer launched once at load and once per request."""
    from gcn_recommendation_tpu_torch.core import distributed
    from gcn_recommendation_tpu_torch.core.mesh import MeshSpec, create_mesh

    cfg = Config(embedding_dim=64, n_layers=3)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=card)
    params = model.init(torch.Generator().manual_seed(0))
    requests = [np.unique(bundle.train.user_idx)[:n].astype(np.int32) for n in (1, 64)]
    single = Retriever.from_params(model, params, bundle, quantize=quantize)
    want = [single.recommend(u, k=20) for u in requests]
    distributed.initialize("cuda", mesh_spec=MeshSpec(1, 1))
    try:
        mesh = create_mesh(MeshSpec(1, 1))
        assert torch.distributed.get_backend() == "nccl"
        before = (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches)
        r = Retriever.from_params(model, params, bundle, quantize=quantize, mesh=mesh)
        got = [r.recommend(u, k=20) for u in requests]
        launched = (quant.quantize_rows_int8.launches - before[0],
                    quant.quantize_users_int8.launches - before[1])
    finally:
        distributed.shutdown()
    for (v, i), (wv, wi) in zip(got, want):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_allclose(v, wv, rtol=1e-6)
    assert launched == ((1, len(requests)) if quantize else (0, 0))
    if quantize:
        n = bundle.num_items
        assert torch.equal(r.item_q[:n], single.item_q[:n])
        assert torch.equal(r.item_scale[:n], single.item_scale[:n])


# ------------------------------------------ merge-skip and chunked layouts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_propagation_matches_cpu_on_card(card, bundle, dtype):
    """``DeviceGraph.layer_sum`` and its backward on the card against the
    same call on the CPU: f32 within 1e-5 (other summation order), bf16
    storage within 2e-2 of the scale (the parts round to 8 mantissa bits)."""
    g = bundle.graph
    emb = torch.randn(g.num_nodes, 64, generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", card):
        dg = to_device_graph(g, compute_dtype=dtype, device=dev)
        x = emb.to(device=dev, dtype=dtype).requires_grad_(True)
        y = dg.layer_sum(x, 3)
        (gx,) = torch.autograd.grad((y ** 2).sum(), x)
        out[str(dev)] = (y.detach().cpu(), gx.float().cpu())
    (y_c, g_c), (y_g, g_g) = out["cpu"], out[str(card)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (y_g - y_c).abs().max().item() <= tol * max(1.0, y_c.abs().max().item())
    assert (g_g - g_c).abs().max().item() <= tol * max(1.0, g_c.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunked_propagation_matches_cpu_on_card(card, bundle, dtype):
    from gcn_recommendation_tpu_torch.ops.spmm import to_device_chunked_graph

    g = bundle.graph
    emb = torch.randn(g.num_nodes, 64, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", card):
        cg = to_device_chunked_graph(g, 3, compute_dtype=dtype, device=dev)
        x = emb.to(device=dev, dtype=dtype).requires_grad_(True)
        y = propagate(x, cg)
        (gx,) = torch.autograd.grad((y.float() ** 2).sum(), x)
        out[str(dev)] = (y.detach().float().cpu(), gx.float().cpu())
    (y_c, g_c), (y_g, g_g) = out["cpu"], out[str(card)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (y_g - y_c).abs().max().item() <= tol * max(1.0, y_c.abs().max().item())
    assert (g_g - g_c).abs().max().item() <= tol * max(1.0, g_c.abs().max().item())


def test_default_trainer_fuses_on_card(card, bundle, tmp_path):
    """The default trainer's step on the card equals its step on the CPU
    (rtol 1e-5), on the fused graph."""
    losses = {}
    for dev in ("cpu", card):
        cfg = Config(embedding_dim=32, n_layers=3, batch_size=256,
                     checkpoint_dir=str(tmp_path), results_dir=str(tmp_path))
        m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
        m.init(torch.Generator().manual_seed(0))
        tr = Trainer(cfg, m, bundle)
        assert tr.graph.fused
        rng = np.random.default_rng(0)
        rows = rng.integers(0, len(bundle.train), 256)
        users = torch.from_numpy(bundle.train.user_idx[rows].astype(np.int64)).to(dev)
        pos = torch.from_numpy(bundle.train.item_idx[rows].astype(np.int64)).to(dev)
        neg = torch.from_numpy(rng.integers(0, bundle.num_items, 256)).to(dev)
        losses[str(dev)] = float(tr.train_step(users, pos, neg))
    np.testing.assert_allclose(losses[str(card)], losses["cpu"], rtol=1e-5)


# ------------------------------------------------ the masked top-k kernel


def _topk_inputs(card, b, n, f, seed, kind="normal"):
    """Scores [b, n] on the card (``kind``: normal; ``ties``, seven levels;
    ``zeros``, -0.0 / +0.0 / +-1) and filter ids [b, f] with about half of
    each row the pad n (duplicates kept: the mask takes them)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    if kind == "ties":
        scores = torch.randint(-3, 4, (b, n), generator=gen, device=card).float() * 0.5
    elif kind == "zeros":
        levels = torch.tensor([-0.0, 0.0, -1.0, -2.0], device=card)
        scores = levels[torch.randint(0, 4, (b, n), generator=gen, device=card)]
    else:
        scores = torch.randn((b, n), generator=gen, device=card)
    filt = torch.randint(0, n, (b, f), generator=gen, device=card)
    filt[torch.rand((b, f), generator=gen, device=card) < 0.5] = n
    filt[0] = n  # an all-pad row
    return scores, filt


def _bits(v):
    return v.contiguous().view(torch.int32)


@pytest.mark.parametrize("b,n,f,k,kind", [
    # the evaluation's batches: [1024, 20000], k = 20, the books tiers' filter widths
    (1024, 20_000, 64, 20, "normal"), (1024, 20_000, 128, 20, "normal"),
    (1024, 20_000, 512, 20, "normal"), (1024, 20_000, 2048, 20, "normal"),
    # the large catalogs (the paper's Amazon-Book, the north star)
    (64, 91_599, 128, 20, "normal"), (32, 200_000, 512, 20, "normal"),
    (16, 200_000, 64, 100, "ties"),
    # planted ties, k at its ends, rows of fewer than k unmasked items
    (256, 20_000, 512, 20, "ties"), (64, 20_000, 64, 1, "ties"),
    (64, 20_000, 64, 1024, "ties"), (128, 5_000, 9_000, 100, "normal"),
    (64, 1_001, 64, 20, "ties"), (8, 37, 60, 20, "normal"), (3, 20_000, 0, 20, "normal"),
])
def test_masked_topk_kernel_bit_equal_to_plain_on_card(card, b, n, f, k, kind):
    scores, filt = _topk_inputs(card, b, n, f, seed=n + f + k, kind=kind)
    before = topk.stable_masked_topk.launches
    v, i = topk.masked_topk(scores, filt, k, stable=True)
    assert topk.stable_masked_topk.launches == before + 1
    v_p, i_p = topk.masked_topk_plain(scores, filt, k)
    torch.cuda.synchronize()
    assert v.shape == (b, min(k, n)) and i.dtype == torch.int64
    assert torch.equal(i, i_p) and torch.equal(_bits(v), _bits(v_p))


def test_masked_topk_kernel_signed_zeros_and_odd_bases_on_card(card):
    """-0.0 and +0.0 tie as one value and keep their sign (against the plain
    version on the CPU: the stable sort there compares, it keeps the
    bits); a row length that is no multiple of 4, or a base that is not
    16-byte aligned, takes the kernel's scalar loads and gives the same."""
    scores, filt = _topk_inputs(card, 256, 4_000, 64, seed=5, kind="zeros")
    v, i = topk.stable_masked_topk(scores, filt, 100)
    v_c, i_c = topk.masked_topk_plain(scores.cpu(), filt.cpu(), 100)
    assert torch.equal(i.cpu(), i_c) and torch.equal(_bits(v.cpu()), _bits(v_c))
    assert (v == 0).any() and torch.signbit(v[v == 0]).any()
    for b, n in ((64, 20_001), (64, 20_000)):
        flat = torch.randn(b * n + 1, device=card)
        x = flat[1:].view(b, n) if n % 4 == 0 else flat[: b * n].view(b, n)
        assert n % 4 or x.data_ptr() % 16 == 4
        _, filt = _topk_inputs(card, b, n, 64, seed=n)
        v, i = topk.stable_masked_topk(x, filt, 20)
        v_p, i_p = topk.masked_topk_plain(x, filt, 20)
        assert torch.equal(i, i_p) and torch.equal(_bits(v), _bits(v_p))


def test_masked_topk_kernel_merge_and_sharded_shapes_on_card(card):
    """``merge_topk_candidates`` ([B, m * k] rows, no mask) and
    ``_mask_local_topk`` (the second of two item shards, ``num_valid_items``
    below the padded catalog) on the card equal their plain runs on the
    CPU, each through one launch."""
    from types import SimpleNamespace

    from gcn_recommendation_tpu_torch.core.mesh import MODEL_AXIS
    from gcn_recommendation_tpu_torch.parallel.spmd import _mask_local_topk

    gen = torch.Generator(device=card).manual_seed(3)
    vals = (torch.randint(-2, 3, (4, 1024, 20), generator=gen, device=card) * 0.25).float()
    vals = vals.sort(dim=2, descending=True).values
    idx = torch.randint(0, 20_000, (4, 1024, 20), generator=gen, device=card)
    before = topk.stable_masked_topk.launches
    v, i = topk.merge_topk_candidates(vals, idx, 20)
    assert topk.stable_masked_topk.launches == before + 1
    v_c, i_c = topk.merge_topk_candidates(vals.cpu(), idx.cpu(), 20)
    assert torch.equal(i.cpu(), i_c) and torch.equal(_bits(v.cpu()), _bits(v_c))

    mesh = SimpleNamespace(shape={MODEL_AXIS: 2}, coordinate=lambda axis: 1)
    shard_items, num_valid = 10_008, 2 * 10_008 - 13
    scores, _ = _topk_inputs(card, 1024, shard_items, 1, seed=4, kind="ties")
    filt = torch.randint(0, num_valid, (1024, 128), generator=gen, device=card)
    filt[:, 64:] = num_valid  # global pads
    before = topk.stable_masked_topk.launches
    v, i = _mask_local_topk(scores, filt, 20, mesh, num_valid_items=num_valid, stable=True)
    assert topk.stable_masked_topk.launches == before + 1
    v_c, i_c = _mask_local_topk(scores.cpu(), filt.cpu(), 20, mesh, num_valid_items=num_valid,
                                stable=True)
    assert torch.equal(i.cpu(), i_c) and torch.equal(_bits(v.cpu()), _bits(v_c))


def test_masked_topk_kernel_refuses_what_it_cannot_take_on_card(card):
    from gcn_recommendation_tpu_torch.kernels._build import load_library

    lib = load_library("masked_topk")
    for n, k in ((20_000, 20), (200_000, 20), (91_599, 1024), (37, 20)):
        s, _ = topk.kernel_plan(n, k, 4 if n % 4 == 0 else 1)
        assert lib.masked_topk_smem_bytes(n, k, s) == topk.kernel_smem_bytes(n, k, s)
    x = torch.zeros((2, 2_000), device=card)
    with pytest.raises(ValueError, match="k up to 1024"):
        topk.stable_masked_topk(x, None, 1_025)
    with pytest.raises(ValueError, match="int64"):
        topk.stable_masked_topk(x, torch.zeros((2, 3), dtype=torch.int32, device=card), 5)
    with pytest.raises(ValueError, match="2-D float32"):
        topk.stable_masked_topk(x.half(), None, 5)
    with pytest.raises(ValueError, match="shared memory"):
        topk.stable_masked_topk(torch.zeros((1, 4_000_000), device=card), None, 20)
    before = topk.stable_masked_topk.launches
    v, i = topk.stable_masked_topk(torch.zeros((0, 50), device=card), None, 20)
    assert v.shape == (0, 20) and topk.stable_masked_topk.launches == before


def test_validate_launches_the_topk_kernel_once_per_eval_batch_on_card(card, bundle):
    """``Trainer.validate`` ranks each eval batch through one launch (the
    ``topk.kernel_rows`` counter counts their rows) and gives the metrics
    of the plain version on the same embeddings; serving's ``stable=False``
    path launches none."""
    from gcn_recommendation_tpu_torch.utils import profiling

    cfg = Config(embedding_dim=32, n_layers=3, eval_user_batch=256)
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                              device=card)
    params = m.init(torch.Generator().manual_seed(0))
    tr = Trainer(cfg, m, bundle)
    before = topk.stable_masked_topk.launches
    with profiling.collect() as rec:
        got = tr.validate()
    batches = tr._eval_batches
    assert len(batches) > 1
    assert topk.stable_masked_topk.launches - before == len(batches)
    assert rec.counters["topk.kernel_rows"] == sum(int(bt[0].shape[0]) for bt in batches)
    with torch.no_grad():
        fu, fi = tr._forward_eval()[:2]
        sums = torch.zeros(3, device=card)
        for users, true_items, filt, valid in batches:
            scores = fu.index_select(0, users).float() @ fi.float().T
            _, idx = topk.masked_topk_plain(scores, filt, cfg.top_k)
            sums += torch.stack(topk.topk_hit_metrics(idx, true_items, valid))
    recall, ndcg, n = sums.tolist()
    np.testing.assert_allclose(got, (recall / n, ndcg / n), rtol=1e-6)
    r = Retriever.from_params(m, params, bundle)
    before = topk.stable_masked_topk.launches
    r.recommend(np.unique(bundle.train.user_idx)[:64], k=20)
    assert topk.stable_masked_topk.launches == before


# ------------------------------------------------ the hit histogram kernel


def _hist_inputs(card, b, k, kind, seed):
    """(topk_idx, true_items, valid) of one evaluation batch on the card:
    the top-k kernel's indices of scores drawn so that ``kind`` occurs
    (``tests/test_torch_evaluate.py::_hist_case`` names the kinds), the
    held-out items hitting at a random column or missing."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n, f = 4 * k + 64, 8
    if kind == "k_above_n":
        n = max(1, k // 2)
    if kind == "masked_ranked":  # n - f < k unmasked items: masked ones rank too
        n = k + 4
        f = min(8, n)
    if kind == "ties":
        scores = torch.randint(-3, 4, (b, n), generator=gen, device=card).float() * 0.5
    else:
        scores = torch.randn((b, n), generator=gen, device=card)
    filt = torch.rand((b, n), generator=gen, device=card).argsort(dim=1)[:, :f].contiguous()
    _, idx = topk.masked_topk(scores, filt, k, stable=True)
    if kind == "repeated_index":
        idx = torch.randint(0, 4, (b, k), generator=gen, device=card)
    if kind == "miss":  # a masked item, below the n - f >= k unmasked ones
        true = filt[:, 0].clone()
    elif kind == "masked_ranked":  # the last column: a masked item when k > n - f
        true = idx[:, -1].clone()
    else:
        pos = torch.randint(0, idx.shape[1], (b, 1), generator=gen, device=card)
        true = torch.where(torch.rand(b, generator=gen, device=card) < 0.3,
                           torch.randint(0, n, (b,), generator=gen, device=card),
                           idx.gather(1, pos)[:, 0])
    valid = torch.ones(b, dtype=torch.bool, device=card)
    if kind == "pad_rows":
        valid = torch.rand(b, generator=gen, device=card) < 0.67
    if kind == "no_valid_row":
        valid[:] = False
    return idx, true, valid


@pytest.mark.parametrize("kind", ["ties", "pad_rows", "masked_ranked", "miss", "k_above_n",
                                  "no_valid_row", "repeated_index"])
@pytest.mark.parametrize("b,k", [(1, 1), (1, 1024), (7, 20), (33, 3), (1024, 20), (1000, 100),
                                 (4096, 20), (4096, 1024)])
def test_hit_histogram_kernel_equals_plain_on_card(card, b, k, kind):
    idx, true, valid = _hist_inputs(card, b, k, kind, seed=b + k)
    before = topk.hit_histogram.launches
    hist = topk.hit_histogram(idx, true, valid, k)
    assert topk.hit_histogram.launches == before + 1
    plain = topk.hit_histogram_plain(idx, true, valid, k)
    torch.cuda.synchronize()
    assert hist.dtype == torch.int32 and hist.shape == (k + 1,)
    assert torch.equal(hist, plain)
    if kind == "miss":
        assert int(hist[:k].sum()) == 0 and int(hist[k]) == b
    if kind == "masked_ranked":
        assert int(hist[:k].sum()) == b
    if kind == "no_valid_row":
        assert int(hist.abs().sum()) == 0


def test_hit_histogram_kernel_refuses_what_it_cannot_take_on_card(card):
    idx = torch.zeros((4, 20), dtype=torch.int64, device=card)
    true = torch.zeros(4, dtype=torch.int64, device=card)
    valid = torch.ones(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="2-D int64"):
        topk.hit_histogram(idx.int(), true, valid, 20)
    with pytest.raises(ValueError, match="true_items"):
        topk.hit_histogram(idx, true[:3], valid, 20)
    with pytest.raises(ValueError, match="valid"):
        topk.hit_histogram(idx, true, valid.int(), 20)
    with pytest.raises(ValueError, match="k up to 1024"):
        topk.hit_histogram(idx, true, valid, 19)
    with pytest.raises(ValueError, match="k up to 1024"):
        topk.hit_histogram(torch.zeros((4, 2), dtype=torch.int64, device=card), true, valid,
                           1025)
    # no row: one launch all the same, every count written as 0
    hist = topk.hit_histogram(idx[:0], true[:0], valid[:0], 20)
    assert hist.tolist() == [0] * 21


def test_validate_launches_the_hit_histogram_once_per_eval_batch_on_card(card, bundle):
    """``Trainer.validate`` reduces each eval batch's top-k through one
    launch of the histogram kernel (the ``eval.hist_rows`` counter counts
    their rows), and its metrics are those of the plain histogram of the
    same top-k, formed alike."""
    from gcn_recommendation_tpu_torch.utils import profiling

    cfg = Config(embedding_dim=32, n_layers=3, eval_user_batch=256)
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                              device=card)
    m.init(torch.Generator().manual_seed(0))
    tr = Trainer(cfg, m, bundle)
    before = topk.hit_histogram.launches
    with profiling.collect() as rec:
        got = tr.validate()
    batches = tr._eval_batches
    assert len(batches) > 1
    assert topk.hit_histogram.launches - before == len(batches)
    assert rec.counters["eval.hist_rows"] == sum(int(bt[0].shape[0]) for bt in batches)
    assert rec.counters["eval.hist_rows"] == rec.counters["topk.kernel_rows"]
    with torch.no_grad():
        fu, fi = tr._forward_eval()[:2]
        hist = torch.zeros(cfg.top_k + 1, dtype=torch.int64, device=card)
        for users, true_items, filt, valid in batches:
            _, idx = topk.masked_topk_scores(fu.index_select(0, users), fi, filt, cfg.top_k,
                                             stable=True)
            hist += topk.hit_histogram_plain(idx, true_items, valid, cfg.top_k)
    hist = hist.tolist()
    n, k = hist[-1], cfg.top_k
    want = (sum(hist[:k]) / n, sum(h / np.log2(p + 2) for p, h in enumerate(hist[:k])) / n)
    assert 0 < want[0] < 1
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------- K1: the ELL bucket kernel

# the books graph's widths (1-128) and the north star's widest (2048-16384,
# split over a block's lane groups); a few rows each
ELL_ROWS = {1: 37, 2: 19, 4: 23, 24: 17, 128: 9, 2048: 4, 16384: 3}


def _ell_buckets(card, d, dtype, n=3000, seed=0):
    """A source table and one bucket of each width in ``ELL_ROWS``, with
    padding slots (id 0, weight 0) as the ELL layout pads a row."""
    rng = np.random.default_rng(seed + d)
    idx, w = [], []
    for width, rows in ELL_ROWS.items():
        i = rng.integers(0, n, (rows, width))
        v = rng.random((rows, width), dtype=np.float32)
        pad = rng.random((rows, width)) < 0.1
        i[pad], v[pad] = 0, 0.0
        idx.append(torch.from_numpy(i).to(card))
        w.append(torch.from_numpy(v).to(card, dtype))
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(card, dtype)
    return x, idx, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 64, 132, 256])
def test_ell_kernel_matches_plain_on_card(card, d, dtype):
    """K1 over one parts table of every width: bit-equal to its own
    summation order (``tests/ell_order.py``); against the plain
    ``_bucket_reduce``, bit-equal at widths up to 4 in float32 (the same
    sum of width-1 gathers) and wider within what two float32 summation
    orders may differ by (``sum_order_bound``); the hub rows left to the
    caller, the zeros row written; one launch, its slots counted."""
    x, idx, w = _ell_buckets(card, d, dtype)
    table = spmm.BucketTable(idx, w, card, hub_rows=5)
    before = spmm.ell_spmm.launches
    with profiling.collect() as rec:
        out = spmm.ell_spmm(x, table, torch.float32)
    torch.cuda.synchronize()
    assert spmm.ell_spmm.launches == before + 1
    assert rec.counters[spmm.KERNEL_SLOTS] == table.slots == sum(i.numel() for i in idx)
    assert out.shape == (table.bucket_rows + 5 + 1, d) and out.dtype == torch.float32
    row = 0
    for i, v in zip(idx, w):
        got = out[row:row + i.shape[0]]
        row += i.shape[0]
        assert torch.equal(got, kernel_order(x, i, v)), f"width {i.shape[1]}"
        plain = spmm._bucket_reduce(x, i, v)
        if i.shape[1] <= spmm.COLSUM_MAX_WIDTH and dtype == torch.float32:
            assert torch.equal(got, plain), f"width {i.shape[1]}"
        else:
            assert ((got - plain).abs() <= sum_order_bound(x, i, v)).all(), f"width {i.shape[1]}"
    assert torch.equal(out[-1], torch.zeros(d, device=card))
    # the output in bfloat16 is the float32 sum rounded once (the hub rows,
    # left unwritten, aside)
    half = spmm.ell_spmm(x, table, torch.bfloat16)
    written = torch.cat([torch.arange(table.bucket_rows), torch.tensor([table.rows - 1])])
    assert torch.equal(half[written], out[written].to(torch.bfloat16))


def test_ell_kernel_split_rows_are_deterministic_on_card(card):
    """Rows split over a block's lane groups (widths 2048 and 16,384) add
    their slices in shared memory in a fixed order: two launches agree bit
    for bit."""
    x, idx, w = _ell_buckets(card, 256, torch.float32)
    table = spmm.BucketTable(idx, w, card)
    assert spmm.describe_buckets([i.shape[1] for i in idx], [i.shape[0] for i in idx])[0][
        :2, 5].tolist() == [1, 1]  # the two widest entries are split, and issued first
    first = spmm.ell_spmm(x, table)
    for _ in range(3):
        assert torch.equal(spmm.ell_spmm(x, table), first)


def test_ell_kernel_refuses_what_it_cannot_take(card):
    x, idx, w = _ell_buckets(card, 64, torch.float32)
    cpu_table = spmm.BucketTable([i.cpu() for i in idx], [v.cpu() for v in w],
                                 torch.device("cpu"))
    with pytest.raises(ValueError, match="buckets on cpu"):
        spmm.ell_spmm(x, cpu_table)
    table = spmm.BucketTable(idx, w, card)
    with pytest.raises(ValueError, match="float32 or bfloat16 table"):
        spmm.ell_spmm(x.half(), table)
    with pytest.raises(ValueError, match="writes float32 or bfloat16"):
        spmm.ell_spmm(x, table, torch.float16)
    with pytest.raises(ValueError, match="CUDA device"):
        spmm.ell_spmm(x.cpu(), table)
    # an unaligned or odd-width table is copied, not refused
    odd = torch.randn((3000 * 50 + 1,), device=card)[1:].view(3000, 50)
    got = spmm.ell_spmm(odd, table)
    row = 0
    for i, v in zip(idx, w):
        assert torch.equal(got[row:row + i.shape[0]], kernel_order(odd, i, v))
        row += i.shape[0]


def _graph_kinds(bundle, device):
    g = bundle.graph
    return {
        "per_layer": to_device_graph(g, device=device, fuse_layers=False),
        "fused": to_device_graph(g, device=device),
        "chunked": spmm.to_device_chunked_graph(g, 2, device=device),
    }


@pytest.mark.parametrize("kind", ["per_layer", "fused", "chunked"])
def test_ell_kernel_launches_once_per_parts_table_on_card(card, bundle, kind):
    """Every parts table a propagation builds is one K1 launch: one a
    per-layer product, K a merge-skip layer sum, one a chunked cell; the
    kernel's slots are the graph's bucket slots."""
    graph = _graph_kinds(bundle, card)[kind]
    x = torch.randn((bundle.graph.num_nodes, 32), device=card)
    before = spmm.ell_spmm.launches
    with profiling.collect() as rec:
        if kind == "fused":
            graph.layer_sum(x, 3)
        else:
            propagate(x, graph)
    launches = spmm.ell_spmm.launches - before
    if kind == "per_layer":
        assert launches == 1 and rec.counters[spmm.KERNEL_SLOTS] == graph.buckets.slots
    elif kind == "fused":
        assert launches == 3
        assert rec.counters[spmm.KERNEL_SLOTS] == (graph.buckets.slots
                                                   + 2 * graph.buckets_perm.slots)
    else:
        cells = [t for chunk in graph.cell_buckets for t in chunk]
        assert launches == len(cells) == 4
        assert rec.counters[spmm.KERNEL_SLOTS] == sum(t.slots for t in cells)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["per_layer", "fused", "chunked"])
def test_propagation_on_card_matches_the_cpu(card, bundle, kind, dtype):
    """``propagate`` forward and backward (and the merge-skip ``layer_sum``)
    over K1 on the card against the same graph on the CPU (the plain
    version): the same sums up to summation order, a few float32 ulps (one
    bfloat16 rounding apart in bfloat16 storage)."""
    g = bundle.graph
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((g.num_nodes, 64), dtype=np.float32)).to(dtype)
    r = torch.from_numpy(rng.standard_normal((g.num_nodes, 64), dtype=np.float32))
    outs = {}
    for dev in ("cpu", card):
        graph = _graph_kinds(bundle, dev)[kind]
        if dtype == torch.bfloat16:
            graph = spmm.to_device_graph(g, torch.bfloat16, dev, fuse_layers=kind == "fused") \
                if kind != "chunked" else spmm.to_device_chunked_graph(g, 2, torch.bfloat16,
                                                                      device=dev)
        x = x0.to(dev).requires_grad_(True)
        y = graph.layer_sum(x, 3) if kind == "fused" else propagate(x, graph)
        (gx,) = torch.autograd.grad((y.float() * r.to(dev)).sum(), x)
        outs[str(dev)] = (y.detach().float().cpu(), gx.float().cpu())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(outs["cpu"], outs[str(card)]):
        torch.testing.assert_close(b, a, **tol)


def test_trainer_takes_the_kernel_for_every_parts_table_on_card(card, bundle):
    """The default ``Trainer`` (merge-skip): a step is 2 x 3 parts tables,
    6 launches, a validation forward 3; ``spmm.kernel_slots`` is the bucket
    part of ``spmm.gathered_rows``."""
    cfg = Config(embedding_dim=64, n_layers=3, batch_size=512)
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                              device=card)
    m.init(torch.Generator().manual_seed(0))
    tr = Trainer(cfg, m, bundle)
    graph = tr.graph
    assert graph.fused
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, len(bundle.train), 512)).to(card)
    neg = torch.from_numpy(rng.integers(0, bundle.num_items, 512)).to(card)
    before = spmm.ell_spmm.launches
    with profiling.collect() as rec:
        tr.train_step(tr.train_users[rows], tr.train_items[rows], neg)
    assert spmm.ell_spmm.launches - before == 6
    per_pass = graph.buckets.slots + 2 * graph.buckets_perm.slots
    assert rec.counters[spmm.KERNEL_SLOTS] == 2 * per_pass
    assert rec.counters[spmm.GATHERED_ROWS] == 2 * (per_pass + graph.gather_idx.shape[0])
    before = spmm.ell_spmm.launches
    tr.validate()
    assert spmm.ell_spmm.launches - before == 3
