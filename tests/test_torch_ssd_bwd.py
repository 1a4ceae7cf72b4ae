"""The SSD scan's gradient on the port's side: ``ssd_reference_bwd`` (the
backward kernel's formulas in plain PyTorch) against autograd through
``ssd_reference`` and against ``jax.vjp`` of the JAX package's
``ssd_chunked`` on the same numpy inputs and cotangents, each gradient
within 1e-4 of its max |g|; the autograd function ``SSDScan`` with both
kernel launches replaced by their plain versions; and the backward's plan
(both paths) against a brute-force count of its blocks and partials."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import tiny_config
from repro_torch.kernels.ssd_scan import SSDScan, ops, ssd_reference, ssd_reference_bwd
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.models import RunCtx, build_model
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.params import tree_leaves, tree_unflatten

GRAD_TOL = 1e-4      # of each gradient's max |g|: the reference's fp32 bound
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")

# (B, L, H, P, N, G, carried init_state, live tokens a row or None)
CASES = {
    "ragged": (2, 27, 2, 8, 4, 2, False, None),
    "groups": (2, 32, 4, 5, 4, 2, False, None),
    "one group": (1, 40, 3, 4, 6, 1, True, None),
    "init_state": (2, 17, 3, 4, 5, 3, True, None),
    "padded row": (2, 40, 4, 8, 8, 2, True, [40, 13]),
    "P3 N4": (1, 16, 2, 3, 4, 2, True, None),
}


def _inputs(seed, B, L, H, P, N, G, init, nvalid):
    """x, dt, A, B_, C, init_state, dy, d_final as numpy fp32; dt = 0 past a
    row's live tokens, as the engine masks a ragged pack."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, L, H, P)).astype(np.float32)
    dt = r.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)
    if nvalid is not None:
        dt *= (np.arange(L)[None, :] < np.asarray(nvalid)[:, None])[..., None]
    A = -r.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (r.standard_normal((B, L, G, N)).astype(np.float32) for _ in range(2))
    s0 = r.standard_normal((B, H, P, N)).astype(np.float32) if init else None
    dy = r.standard_normal((B, L, H, P)).astype(np.float32)
    d_final = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0, dy, d_final


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _plain_bwd(x, dt, A, Bm, Cm, s0, dy, d_final, tile):
    """ssd_reference_bwd from the entry states ssd_reference gives at
    ``tile``-token chunks."""
    rep = x.shape[2] // Bm.shape[2]
    _, _, states = ssd_reference(x, dt, A, Bm.repeat_interleave(rep, 2),
                                 Cm.repeat_interleave(rep, 2), tile, init_state=s0, states=True)
    return ssd_reference_bwd(x, dt, A, Bm, Cm, s0, states, dy, d_final, tile=tile)


def _close(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, name


@pytest.mark.parametrize("tile", [4, 8, 64])
@pytest.mark.parametrize("chunk", [4, 8, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_bwd_matches_autograd(case, chunk, tile):
    """Every gradient, the carried state's too, against autograd through
    ssd_reference at the forward's chunk length: the backward's tile length
    need not be the forward's chunk (the result does not depend on it)."""
    x, dt, A, Bm, Cm, s0, dy, d_final = map(_t, _inputs(7, *CASES[case]))
    rep = x.shape[2] // Bm.shape[2]
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    init = None if s0 is None else s0.clone().requires_grad_()
    y, s = ssd_reference(leaves[0], leaves[1], leaves[2], leaves[3].repeat_interleave(rep, 2),
                         leaves[4].repeat_interleave(rep, 2), chunk, init_state=init)
    want = torch.autograd.grad((y * dy).sum() + (s * d_final).sum(),
                               leaves + ([init] if init is not None else []))
    got = _plain_bwd(x, dt, A, Bm, Cm, s0, dy, d_final, tile)
    assert (got[5] is None) == (s0 is None)
    _close(got, [g.numpy() for g in want] + [None] * (s0 is None))
    if case == "padded row":       # tokens past a row's end get no gradient through dt = 0
        assert not got[0][1, 13:].any() and not got[3][1, 13:].any()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_bwd_matches_jax_vjp(case):
    """Against jax.vjp of repro.models.mamba.ssd_chunked (B / C repeated to
    the heads on the JAX side, its dB / dC summed back over each group)."""
    x, dt, A, Bm, Cm, s0, dy, d_final = _inputs(11, *CASES[case])
    H, G = x.shape[2], Bm.shape[2]
    rep = H // G

    def f(x_, dt_, A_, B_, C_, *init):
        return jax_ssd_chunked(x_, dt_, A_, jnp.repeat(B_, rep, 2), jnp.repeat(C_, rep, 2), 8,
                               init_state=init[0] if init else None)

    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + ([jnp.asarray(s0)]
                                                            if s0 is not None else [])
    _, vjp = jax.vjp(f, *args)
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(d_final)))]
    got = _plain_bwd(*map(_t, (x, dt, A, Bm, Cm, s0, dy, d_final)), 64)
    _close([None if g is None else g.numpy() for g in got], want + [None] * (s0 is None))


def _plain_fwd(x, dt, A, B_, C, init_state=None, states=False):
    """ssd_scan_cuda's contract from the plain version (64-token tiles)."""
    _plain_fwd.calls += 1
    rep = x.shape[2] // B_.shape[2]
    return ssd_reference(x, dt, A, B_.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2),
                         K.TILE, init_state=init_state, states=states)


def _plain_bwd_launch(x, dt, A, B_, C, states, dy, d_final=None, *, need_x=True, need_dt=True,
                      need_A=True, need_BC=True, need_init=True):
    """ssd_scan_bwd_cuda's contract from the plain version: the gradients
    asked for, dx / dB / dC in x's dtype."""
    _plain_bwd_launch.asked.append((need_x, need_dt, need_A, need_BC, need_init))
    init = states[:, 0] if need_init else None
    g = ssd_reference_bwd(x, dt, A, B_, C, init, states, dy, d_final, tile=K.TILE)
    keep = (need_x, need_dt, need_A, need_BC, need_BC, need_init)
    cast = (True, False, False, True, True, False)
    return tuple(None if not k else (t.to(x.dtype) if c else t)
                 for t, k, c in zip(g, keep, cast))


@pytest.fixture
def plain_launches(monkeypatch):
    _plain_fwd.calls = 0
    _plain_bwd_launch.asked = []
    monkeypatch.setattr(ops, "ssd_scan_cuda", _plain_fwd)
    monkeypatch.setattr(ops, "ssd_scan_bwd_cuda", _plain_bwd_launch)


@pytest.mark.parametrize("wants", [("x",), ("dt", "A"), ("B", "C"), ("x", "init"),
                                   ("x", "dt", "A", "B", "C", "init")])
def test_ssd_scan_function_asks_only_for_needed_grads(plain_launches, wants):
    """SSDScan with both launches plain: the backward asks the kernel for
    the gradients in needs_input_grad only, returns None for the others,
    and the ones it returns equal autograd through ssd_reference."""
    x, dt, A, Bm, Cm, s0, dy, d_final = map(_t, _inputs(3, *CASES["padded row"]))
    keys = ("x", "dt", "A", "B", "C", "init")
    ins = [t.clone().requires_grad_(k in wants) for k, t in zip(keys, (x, dt, A, Bm, Cm, s0))]
    y, s = SSDScan.apply(*ins)
    assert _plain_fwd.calls == 1
    got = torch.autograd.grad((y * dy).sum() + (s * d_final).sum(),
                              [t for t in ins if t.requires_grad])
    assert _plain_bwd_launch.asked == [("x" in wants, "dt" in wants, "A" in wants,
                                        "B" in wants or "C" in wants, "init" in wants)]
    ref = [t.clone().requires_grad_(k in wants) for k, t in zip(keys, (x, dt, A, Bm, Cm, s0))]
    rep = x.shape[2] // Bm.shape[2]
    y2, s2 = ssd_reference(ref[0], ref[1], ref[2], ref[3].repeat_interleave(rep, 2),
                           ref[4].repeat_interleave(rep, 2), 16, init_state=ref[5])
    want = torch.autograd.grad((y2 * dy).sum() + (s2 * d_final).sum(),
                               [t for t in ref if t.requires_grad])
    _close([g.numpy() for g in got], [g.numpy() for g in want], names=wants)


def test_ssd_scan_function_dtypes_and_unused_final_state(plain_launches, monkeypatch):
    """bf16 x / B / C: dx, dB and dC come back in bf16, ddt, dA and the
    carried state's gradient in fp32; a final state the loss does not use
    sends the backward no gradient (None, not zeros)."""
    x, dt, A, Bm, Cm, s0, dy, _ = map(_t, _inputs(5, *CASES["groups"][:6], True, None))
    xb, Bb, Cb = (t.to(torch.bfloat16).requires_grad_() for t in (x, Bm, Cm))
    dtg, Ag, s0g = (t.clone().requires_grad_() for t in (dt, A, s0))
    seen = []
    real = ops.ssd_scan_bwd_cuda

    def spy(*args, **kw):
        seen.append(args[7])                      # d_final
        return real(*args, **kw)

    monkeypatch.setattr(ops, "ssd_scan_bwd_cuda", spy)
    y, s = SSDScan.apply(xb, dtg, Ag, Bb, Cb, s0g)
    assert y.dtype == s.dtype == torch.float32
    gx, gdt, gA, gB, gC, gs = torch.autograd.grad((y * dy).sum(), (xb, dtg, Ag, Bb, Cb, s0g))
    assert seen == [None]
    assert gx.dtype == gB.dtype == gC.dtype == torch.bfloat16
    assert gdt.dtype == gA.dtype == gs.dtype == torch.float32
    assert gB.shape == Bm.shape and gs.shape == s0.shape and gA.shape == A.shape


def test_mamba_layer_gradients_reach_dt_bias_and_a_log(plain_launches, monkeypatch):
    """Tiny mamba2's loss with the model's ssd_chunked routed through
    SSDScan (plain launches), as a CUDA tensor under grad takes it: every
    leaf's gradient, dt_bias and A_log included, equals the CPU path's
    (autograd through ssd_reference)."""
    model = build_model(tiny_config("mamba2-1.3b"))
    params = model.init_params(0, device="cpu", dtype=torch.float32)
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(0, model.cfg.vocab, (2, 40)).astype(np.int32)),
             "labels": torch.from_numpy(r.integers(0, model.cfg.vocab, (2, 40)).astype(np.int32))}
    ctx = RunCtx(mode="train", moe_strategy="capacity", remat=True)

    def grads():
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), batch, ctx)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    want_loss, want = grads()

    def through_function(x, dt, A, B_, C, chunk, init_state=None):
        return SSDScan.apply(x, dt.float().contiguous(), A.float().contiguous(), B_, C,
                             init_state)

    monkeypatch.setattr(mamba_mod, "ssd_chunked", through_function)
    loss, got = grads()
    # remat: each layer's forward runs twice (the second under grad), its
    # backward once
    n_layers = model.cfg.n_layers
    assert _plain_fwd.calls == 2 * n_layers and len(_plain_bwd_launch.asked) == n_layers
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    names = [k for k, _ in _named_leaves(params)]
    assert any(n.endswith("dt_bias") for n in names) and any(n.endswith("A_log") for n in names)
    for name, g, w in zip(names, got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, name
        if name.endswith(("dt_bias", "A_log")):
            assert float(w.abs().max()) > 0, name


def _named_leaves(tree, prefix=""):
    """(path, leaf) in tree_leaves' order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,G", [(1, 1, 1, 1, 1, 1), (2, 27, 2, 8, 4, 2),
                                         (2, 150, 4, 64, 128, 2), (4, 512, 64, 64, 128, 1),
                                         (4, 512, 128, 64, 16, 1), (3, 130, 6, 3, 5, 3)])
def test_bwd_plan_matches_a_brute_force_count(B, L, H, P, N, G, dtype):
    """The grid has a block a (row, hb heads of one group); walking each
    block's tiles writes every element of the dB / dC partials and of ddt
    once, each (row, head) of dA's once, and each group's dB / dC are the
    sum of its H / G / hb blocks' slots; the shared memory is the kernel's
    arrays' and fits the card. fp32 takes the tiled kernel (hb 1, per-head
    partials (B, L, H, N)), bf16 the mma one ((H / G / hb, B, L, G, N))."""
    plan = K.bwd_plan(B, L, H, P, N, G, dtype, 132)
    hb = plan["hb"]
    assert plan["path"] == ("mma" if dtype == torch.bfloat16 else "tiled")
    assert plan["grid"][0] * plan["grid"][1] * plan["grid"][2] == plan["blocks"]
    rep = H // G
    part = plan["partials"]["dB"]
    writes = np.zeros((B, L, H), np.int64)
    part_writes = np.zeros(part[:-1], np.int64)
    dA_writes = np.zeros((B, H), np.int64)
    for blk in range(plan["grid"][0]):
        heads = range(blk * hb, (blk + 1) * hb)
        g = heads[0] // rep
        assert len({h // rep for h in heads}) == 1      # one group a block
        for b in range(plan["grid"][1]):
            for h in heads:
                dA_writes[b, h] += 1
            for t in reversed(range(plan["tiles"])):
                for j in range(K.TILE):
                    if t * K.TILE + j < L:
                        if plan["path"] == "mma":      # the block's slot of its group
                            part_writes[blk % (rep // hb), b, t * K.TILE + j, g] += 1
                        else:
                            part_writes[b, t * K.TILE + j, blk] += 1
                        for h in heads:
                            writes[b, t * K.TILE + j, h] += 1
    assert (writes == 1).all() and (part_writes == 1).all() and (dA_writes == 1).all()
    want = (rep // hb, B, L, G, N) if plan["path"] == "mma" else (B, L, H, N)
    assert plan["partials"] == {"dB": want, "dC": want, "dA": (B, H)}
    assert plan["group_sum"] == rep // hb
    if plan["path"] == "tiled":
        PP, NP, T = -(-P // 4) * 4, -(-N // 8) * 8, K.TILE
        arrays = dict(xT=PP * (T + 4), dyT=PP * (T + 4), dyr=T * PP, bT=NP * (T + 4),
                      cT=NP * (T + 4), dsp=PP * (NP + 4), gm=T * (T + 4), m2=T * (T + 4),
                      m2t=T * (T + 4), partials=3 * 16 * T, vectors=8 * T, scalars=16)
        assert plan["smem"] == 4 * sum(arrays.values()) <= K.BWD_SMEM_MAX <= 232448
    else:
        assert plan["smem"] == K.bwd_mma_smem_bytes(hb, plan["nk"]) <= K.SMEM_LIMIT == 232448


def test_bwd_plan_refuses_what_the_kernel_does_not_take():
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head_dim 65"):
            K.bwd_plan(1, 8, 2, 65, 16, 1, dtype, 132)
        with pytest.raises(ValueError, match="d_state 129"):
            K.bwd_plan(1, 8, 2, 64, 129, 1, dtype, 132)
        with pytest.raises(ValueError, match="3 heads over 2 groups"):
            K.bwd_plan(1, 8, 3, 8, 16, 2, dtype, 132)
        with pytest.raises(ValueError, match="grid"):
            K.bwd_plan(70000, 8, 2, 8, 16, 1, dtype, 132)
    assert K.bwd_smem_bytes(64, 128) == K.BWD_SMEM_MAX


def test_bwd_wrapper_refuses_cpu_tensors():
    x, dt, A, Bm, Cm, s0, dy, _ = map(_t, _inputs(1, *CASES["ragged"]))
    states = torch.zeros((2, 1, 2, 8, 4))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        K.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, states, dy)
