"""Port's grouped expert matmul vs the JAX package: the plain version and
``ops.gmm`` against JAX ``gmm`` (Pallas, interpret mode) over ragged group
sizes (empty groups, single-expert skew), a hypothesis sweep, bf16 and
int8 experts (against JAX ``gmm`` on the dequantized experts); the kernel's
tile-aligned layout at the plan's row tiles; the kernel's plan (path, grid
and split ranges) at mixtral's shapes; and ``moe_dropless`` against the
JAX layer on tiny mixtral. The CUDA kernel against the plain version is in
test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st

from repro.configs import tiny_config as jax_tiny_config
from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.models.moe import moe_dropless as jax_moe_dropless
from repro.quant import dequantize_tree as jax_dequantize_tree
from repro.quant import quantize_params_int8 as jax_quantize_params_int8
from repro_torch.configs import tiny_config
from repro_torch.kernels.moe_gmm import GroupedRows, gmm, gmm_reference, tile_layout
from repro_torch.kernels.moe_gmm import kernel as gk
from repro_torch.kernels.quant_matmul.kernel import split_ranges
from repro_torch.models import RunCtx
from repro_torch.models.moe import moe_dropless
from repro_torch.models.params import params_from_numpy
from repro_torch.quant import QuantizedLinear


def _run(rng, group_sizes, K=16, N=24, block_m=8):
    gs = np.asarray(group_sizes, np.int32)
    M, E = int(gs.sum()), len(gs)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    ref = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                             backend="pallas", interpret=True, block_m=block_m, block_n=8))
    tx, tw, tg = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs)
    np.testing.assert_allclose(gmm(tx, tw, tg).numpy(), ref,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gmm_reference(tx, tw, tg).numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sizes", [[8, 8, 8, 8], [0, 32, 0, 1], [33], [1, 1, 1, 1, 29]])
def test_gmm_fixed(rng, sizes):
    _run(rng, sizes)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 20), min_size=1, max_size=6).filter(lambda s: sum(s) > 0))
def test_gmm_hypothesis(sizes):
    _run(np.random.default_rng(sum(sizes)), sizes)


def test_gmm_bf16(rng):
    gs = np.asarray([5, 11], np.int32)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((2, 32, 16)).astype(np.float32)
    ref = jax_gmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(gs),
                  backend="pallas", interpret=True, block_m=8, block_n=8)
    out = gmm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
              torch.from_numpy(gs))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("sizes", [[8, 8, 8, 8], [0, 70, 0, 1]])
def test_gmm_int8_experts(rng, sizes):
    """int8 experts with the int8 tree's scale per (expert, input row), as
    JAX's quantize_params_int8 makes them: the port's gmm on the bridged
    QuantizedLinear against JAX gmm (Pallas, interpret mode) on the
    dequantized experts."""
    gs = np.asarray(sizes, np.int32)
    M, E, K, N = int(gs.sum()), len(gs), 64, 264          # E*K*N >= 1 << 14
    x = rng.standard_normal((M, K)).astype(np.float32)
    jq = jax_quantize_params_int8({"w": jnp.asarray(rng.standard_normal((E, K, N)),
                                                    jnp.float32)})
    ref = jax_gmm(jnp.asarray(x), jax_dequantize_tree(jq, jnp.float32)["w"], jnp.asarray(gs),
                  backend="pallas", interpret=True, block_m=8, block_n=8)
    w = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")["w"]
    assert isinstance(w, QuantizedLinear) and w.scale.shape == (E, K, 1)
    tg = torch.from_numpy(gs)
    np.testing.assert_allclose(gmm(torch.from_numpy(x), w, tg).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sizes,block_m", [([0, 32, 0, 1], 8), ([3, 0, 70, 1], 64),
                                           ([0, 0, 0, 5], 8)])
def test_tile_layout(sizes, block_m):
    """Every expert starts on a tile boundary; each real row lands in a
    tile of its own expert; padding tiles hold no row."""
    gs = torch.tensor(sizes)
    M, E = int(gs.sum()), len(sizes)
    dst, tile_expert, tile_rows, Mp = tile_layout(gs, M, block_m)
    T = Mp // block_m
    assert Mp == ((M + block_m - 1) // block_m + E) * block_m
    assert tile_expert.shape == tile_rows.shape == (T,)
    assert int(tile_rows.sum()) == M and len(set(dst.tolist())) == M
    eid = np.repeat(np.arange(E), sizes)
    for m, d in enumerate(dst.tolist()):
        t, r = divmod(d, block_m)
        assert int(tile_expert[t]) == eid[m] and r < int(tile_rows[t])
    real_tiles = sum((n + block_m - 1) // block_m for n in sizes)
    assert (tile_rows[real_tiles:] == 0).all() and (tile_expert[real_tiles:] == E - 1).all()


def test_tile_layout_per_tile_matmul(rng):
    """What the kernel computes on the layout, tile by tile (each tile's
    real rows times its expert's weights), gives the plain version's rows;
    the NaN padding rows never reach them. On the CPU, ``GroupedRows``
    leaves the rows as they are."""
    gs = torch.tensor([0, 3, 0, 9])
    x = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8, 5)).astype(np.float32))
    dst, te, tr, Mp = tile_layout(gs, 12, 4)
    xp = torch.full((Mp, 8), float("nan"))
    xp[dst] = x
    out = torch.full((Mp, 5), float("nan"))
    for t, (e, n) in enumerate(zip(te.tolist(), tr.tolist())):
        out[4 * t:4 * t + n] = xp[4 * t:4 * t + n] @ w[e]
    torch.testing.assert_close(out[dst], gmm_reference(x, w, gs), atol=1e-6, rtol=1e-6)
    rows = GroupedRows(gs, x)
    assert rows.pack(x) is x and rows.unpack(x) is x


def test_moe_dropless_matches_jax():
    name = "mixtral-8x7b"
    jcfg = jax_tiny_config(name)
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    jmoe = jax.tree.map(lambda a: a[0], jp["groups"][0]["layers"][0]["moe"])
    x = np.random.default_rng(3).standard_normal((24, jcfg.d_model)).astype(np.float32)
    ctx = JaxRunCtx(attn_backend="pallas", moe_strategy="dropless", interpret=True)
    y_ref, aux_ref = jax_moe_dropless(jmoe, jnp.asarray(x), jcfg, ctx)
    tmoe = params_from_numpy(jax.tree.map(np.asarray, jmoe), device="cpu")
    y, aux = moe_dropless(tmoe, torch.from_numpy(x), tiny_config(name), RunCtx())
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before it
    loads or builds anything."""
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    x = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        gmm_tiles_cuda(x, torch.zeros((2, 8, 4)), torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_m"):
        gmm_tiles_cuda(x, torch.zeros((2, 8, 4)), torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32), block_m=8)


H100_SMS = 132
MIXTRAL = [(4096, 14336), (14336, 4096)]      # (K, N) of w_gate / w_up, then w_down


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 512])
@pytest.mark.parametrize("K,N", MIXTRAL + [(40, 130), (64, 24)])
def test_gmm_plan(M, K, N, x_dtype, w_dtype):
    """The plan streams M <= 16 rows in all (every expert then has <= 16),
    takes the tensor cores for bf16 x on bf16 or int8 experts above that and
    the fp32 tiles otherwise; its grids stay within CUDA's limits, its row
    tile is the layout's, a streaming split's slice of x fits the staging
    buffer, and the split ranges cover K once, in order."""
    E = 8
    plan = gk._plan(M, K, N, E, x_dtype, w_dtype, H100_SMS)
    want = "stream" if M <= 16 else (
        "mma" if x_dtype == torch.bfloat16 and w_dtype != torch.float32 else "tiled")
    assert plan.path == want
    assert plan.block_m == gk.block_m_for(M) == (16 if M <= 16 else 64)
    assert all(1 <= g <= lim for g, lim in zip(plan.grid, gk.GRID_LIMITS))
    tiles = -(-M // plan.block_m) + E
    ranges = split_ranges(K, plan.splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(kb % gk.SPLIT_ROWS == 0 for kb, _ in ranges)
    if plan.path == "stream":
        assert plan.grid == (-(-N // gk.STREAM_BLOCK_N) * plan.groups, plan.splits, tiles)
        assert plan.rows in (1, 2, 4) and plan.rows * plan.groups >= min(M, plan.block_m)
        assert max(ke - kb for kb, ke in ranges) * plan.rows <= gk.XS_FLOATS
        # the likely-active tiles give >= 2 blocks a SM, unless K runs out
        live = -(-N // gk.STREAM_BLOCK_N) * min(M, E) * plan.splits
        assert live >= 2 * H100_SMS or plan.splits == -(-K // gk.SPLIT_ROWS)
    elif plan.path == "mma":
        assert plan.grid == (-(-N // gk.MMA_TILE[1]), tiles, plan.splits)
        assert plan.splits <= gk.MMA_MAX_SPLITS
        assert plan.splits == 1 or min(ke - kb for kb, ke in ranges) >= gk.MMA_MIN_SPLIT_K - 16
    else:
        assert plan.grid == (-(-N // gk.TILED_TILE[1]), tiles, 1) and plan.splits == 1


def test_gmm_plan_at_mixtral_shapes():
    """The plans chip_smoke.py times: decode splits K (more for the down
    projection, whose 16 column blocks a tile give the fewest blocks); over
    a prefill pack of 512 rows the up projection's ~1344 tiles fill ~5
    waves alone, the down projection's ~384 fill 1.45, so it splits K in
    two (2.9 waves of half the work)."""
    p = {(M, K): gk._plan(M, K, N, 8, torch.bfloat16, torch.int8, H100_SMS)
         for M in (8, 16, 512) for K, N in MIXTRAL}
    assert p[16, 4096].splits == 4 and p[16, 14336].splits == 14
    assert p[8, 4096].groups == 2 and p[16, 4096].groups == 4 and p[16, 4096].rows == 4
    assert p[512, 4096].path == p[512, 14336].path == "mma"
    assert p[512, 4096].splits == 1 and p[512, 14336].splits == 2


@pytest.mark.parametrize("sizes", [[0, 1, 0, 0], [0, 0, 16, 0], [3, 0, 5, 0, 8], [0, 17, 0],
                                   [300, 100, 0, 50, 62]])
def test_tile_layout_at_plan_row_tile(sizes):
    """At the plan's row tile (16 rows up to M = 16, 64 above) every row
    lands in a tile of its own expert and padding tiles hold no row."""
    gs = torch.tensor(sizes)
    M, E = int(gs.sum()), len(sizes)
    bm = gk.block_m_for(M)
    dst, tile_expert, tile_rows, Mp = tile_layout(gs, M, bm)
    assert Mp == (-(-M // bm) + E) * bm
    eid = np.repeat(np.arange(E), sizes)
    for m, d in enumerate(dst.tolist()):
        t, r = divmod(d, bm)
        assert int(tile_expert[t]) == eid[m] and r < int(tile_rows[t])
    real = sum(-(-n // bm) for n in sizes)
    assert int(tile_rows.sum()) == M and (tile_rows[real:] == 0).all()
    assert (tile_rows[:real] > 0).all()


@pytest.mark.parametrize("sizes", [[0, 1, 0, 0], [3, 0, 5, 0, 8], [0, 17, 0], [30, 0, 41]])
@pytest.mark.parametrize("int8", [False, True])
def test_grouped_rows_layout_matches_jax(rng, sizes, int8):
    """What the kernel computes on the layout at the plan's row tile, tile
    by tile over each tile's real rows (NaN padding never reaches them),
    against JAX ``gmm`` (Pallas, interpret mode), on float and int8
    experts."""
    gs = np.asarray(sizes, np.int32)
    M, E, K, N = int(gs.sum()), len(gs), 64, 264
    x = rng.standard_normal((M, K)).astype(np.float32)
    wf = rng.standard_normal((E, K, N)).astype(np.float32)
    if int8:
        jq = jax_quantize_params_int8({"w": jnp.asarray(wf)})
        jw = jax_dequantize_tree(jq, jnp.float32)["w"]
        w = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")["w"]
        wd = w.q.float() * w.scale
    else:
        jw, w = jnp.asarray(wf), torch.from_numpy(wf)
        wd = w
    ref = jax_gmm(jnp.asarray(x), jw, jnp.asarray(gs), backend="pallas", interpret=True,
                  block_m=8, block_n=8)
    bm = gk.block_m_for(M)
    dst, te, tr, Mp = tile_layout(torch.from_numpy(gs), M, bm)
    xp = torch.full((Mp, K), float("nan"))
    xp[dst] = torch.from_numpy(x)
    out = torch.full((Mp, N), float("nan"))
    for t, (e, n) in enumerate(zip(te.tolist(), tr.tolist())):
        out[bm * t:bm * t + n] = xp[bm * t:bm * t + n] @ wd[e]
    np.testing.assert_allclose(out[dst].numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gmm(torch.from_numpy(x), w, torch.from_numpy(gs)).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=1e-4)
