"""Training under a mesh on gloo CPU ranks against the JAX package's train
step under the same mesh.

The port's side runs on four spawned ranks (``distributed.ranks``,
``tests/torch_dist_train_worker.py``; a mesh of two binds the first two);
the reference's in two child processes whose environment alone sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``tests/torch_dist_train_reference.py``: ``value_and_grad(model.loss)`` and
``make_train_step``'s ``step_fn``, jitted with the train rules' shardings as
the reference's dry-run builds its train cell); all from the same numpy
parameters and batch, at once. Cases, tiny configs in fp32 on meshes
(data, expert, tensor): qwen2.5 and gemma2 (tied head, softcaps) at (2, 1,
2); qwen2.5 at (1, 1, 4) (``kv_seq``: its 2 kv heads whole on every
tensor rank); mixtral at (1, 2, 2) ``ep_shardmap``, (2, 1, 2)
``tp_shardmap`` and (2, 2, 1) ``ep_shardmap``; deepseek-moe (shared
experts) at (2, 2, 1); mamba2 at (1, 1, 2) and (2, 1, 2); jamba (mamba,
attention and the MoE) at (1, 2, 2) ``ep_shardmap``; seamless (encoder,
cross attention, 12 frames a row) and phi-3-vision (the patch prefix) at
(2, 1, 2); MoE capacity factor E / K (nothing drops). Held:

- each rank's loss against its device's (the MoE aux of its own data
  shard, as the reference's ``shard_map(check_rep=False)`` reports it),
  within 1e-5 relative;
- each rank's reduced gradient shard against the slice of the reference's
  gradient, within 1e-5 of the slice's max |g| (the aux term enters as its
  mean over the data shards); jamba's through the next two checks alone
  (``NOISY_GRADS``);
- ``global_norm`` of the rank's shards against the norm of the reference's
  gradient, within 1e-5 relative;
- one ``step_fn`` with 2 microbatches and int8 gradients: each rank's loss;
  AdamW's m / v against the reference's slices within phase 12 (c)'s
  bounds (1e-5 of the leaf's max plus one int8 quantum: a rounding flip
  moves the global norm, so every element's clip); the error feedback
  (before the clip) within 1e-5 of the gradient, an element that rounded
  the other way aside; and the new parameters against AdamW recomputed in
  float64 from the rank's own moments;
- the trainer on (2, 1, 2): a crash at step 2 after a checkpoint there, and
  the resume, equal the uninterrupted run; the checkpoint holds the global
  tree, which the unsharded trainer restores equal to the ranks' gathered
  state;
- the sequence-parallel rule (``make_rules("train", seq_shard=True)``) on
  tiny qwen2.5 at (2, 1, 2) and (1, 1, 4) (kv_seq), mixtral at (2, 1, 2)
  ``tp_shardmap`` and (1, 2, 2) ``ep_shardmap``: each rank's loss, reduced
  gradient shards and ``global_norm`` against the reference's on the same
  mesh without the rule (``with_sharding_constraint`` changes nothing the
  reference computes), at the bounds above.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))          # the spawned ranks import the worker by name

import torch_dist_train_worker  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.distributed.ranks import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import map_tree, tree_leaves  # noqa: E402

TOL = 1e-5
# the reference children lower them in this order while earlier ones
# compile: the slowest to compile first
CASES = [("jamba-v0.1-52b", (1, 2, 2), "ep_shardmap"),          # mamba, the MoE and attention
         ("deepseek-moe-16b", (2, 2, 1), "ep_shardmap"),
         ("seamless-m4t-large-v2", (2, 1, 2), "tp_shardmap"),   # encoder and cross attention
         ("mixtral-8x7b", (1, 2, 2), "ep_shardmap"), ("mixtral-8x7b", (2, 1, 2), "tp_shardmap"),
         ("mixtral-8x7b", (2, 2, 1), "ep_shardmap"),
         ("phi-3-vision-4.2b", (2, 1, 2), "tp_shardmap"),       # the patch prefix
         ("mamba2-1.3b", (1, 1, 2), "tp_shardmap"), ("mamba2-1.3b", (2, 1, 2), "tp_shardmap"),
         ("qwen2.5-3b", (1, 1, 4), "tp_shardmap"),              # kv_seq: kv 2 at tensor 4
         ("gemma2-27b", (2, 1, 2), "tp_shardmap"), ("qwen2.5-3b", (2, 1, 2), "tp_shardmap")]
# the sequence-parallel rule on cases above: held against their reference
SEQ_CASES = [("qwen2.5-3b", (2, 1, 2), "tp_shardmap", "seq"),
             ("qwen2.5-3b", (1, 1, 4), "tp_shardmap", "seq"),      # kv_seq and seq meet
             ("mixtral-8x7b", (2, 1, 2), "tp_shardmap", "seq"),
             ("mixtral-8x7b", (1, 2, 2), "ep_shardmap", "seq")]
LOSS_KW = dict(xent_chunk=0)           # the step below runs the chunked cross-entropy
# lr 1e-4, as tests/test_torch_train_step.py: AdamW's first step turns a
# rounding difference of a gradient element near eps into ~lr
STEP_KW = dict(peak_lr=1e-4, warmup=2, total_steps=10, microbatches=2, grad_compression=True,
               xent_chunk=8)
TRAINER = dict(case=CASES[-1], step_kw=dict(STEP_KW, peak_lr=1e-3))
ADAMW_RTOL = 1e-5
ids = [f"{a}-{'x'.join(map(str, s))}-{st}" for a, s, st in CASES]
seq_ids = [f"{a}-{'x'.join(map(str, s))}-{st}-seq" for a, s, st, _ in SEQ_CASES]


def _batch(arch):
    """4 rows of 16 tokens (2 microbatches of a row a data rank at data
    2), a tenth of the labels masked; 12 frames a row for an enc-dec
    config, the patches for a VLM."""
    r = np.random.default_rng(5)
    labels = r.integers(0, 256, (4, 16)).astype(np.int32)
    labels[r.random(labels.shape) < 0.1] = -1
    batch = {"tokens": r.integers(1, 256, (4, 16)).astype(np.int32), "labels": labels}
    cfg = tiny_config(arch)
    if cfg.encoder is not None:
        batch["frames"] = r.standard_normal((4, 12, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = r.standard_normal(
            (4, cfg.vision.n_patches, cfg.vision.d_patch)).astype(np.float32)
    return batch


def _ranks(case):
    """The ranks of the case's mesh: the first of the world's four."""
    return range(int(np.prod(case[1])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    # the port's seeded init as numpy (no JAX compile before the child starts)
    archs = sorted({c[0] for c in CASES})
    params = {a: map_tree(lambda t: t.numpy(), build_model(tiny_config(a)).init_params(
        1, device="cpu")) for a in archs}
    inputs = d / "inputs.pkl"
    common = {"params": params, "batches": {a: _batch(a) for a in archs}, "loss_kw": LOSS_KW,
              "step_kw": STEP_KW, "trainer": TRAINER}
    with open(inputs, "wb") as f:
        pickle.dump(dict(common, cases=CASES, seq_cases=SEQ_CASES), f)
    # LLVM's optimization level 0 compiles the six steps ~6 s sooner (the
    # float semantics are XLA's: no fast math at either level)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"), env.get("PYTHONPATH", "")])
    # two reference children, each tracing its cases while the other does
    # (a child traces one case at a time): the slowest case alone (jamba:
    # 17 s to trace, 37 s to compile) and the rest (46 s to trace)
    children = []
    for i, group in enumerate((CASES[:1], CASES[1:])):
        with open(d / f"inputs{i}.pkl", "wb") as f:
            pickle.dump(dict(common, cases=group), f)
        children.append(subprocess.Popen(
            [sys.executable, str(HERE / "torch_dist_train_reference.py"), str(d / f"inputs{i}.pkl"),
             str(d / f"ref{i}.pkl")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        port = spawn_ranks(torch_dist_train_worker.run_all, 4, (str(inputs),),
                           store_dir=d / "ranks", timeout_s=240)
        logs = [child.communicate(timeout=240)[0] for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    ref = {}
    for i, (child, log) in enumerate(zip(children, logs)):
        assert child.returncode == 0, log
        with open(d / f"ref{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return params, ref, port


@pytest.mark.parametrize("op", ["psum", "pmean", "pmax", "all_gather", "all_to_all"])
def test_each_collective_backward_is_its_transpose(runs, op):
    """On (2, 1, 2), ``x`` each rank's own: the loss every rank computes,
    ``shared_out(sum(op(x) * w))``, has the gradient of the global function
    of all ranks' ``x`` (the mean of the ranks' losses for the all-to-all,
    whose outputs differ by rank)."""
    import torch
    _, _, port = runs
    got = [port[r]["collectives"][op] for r in range(4)]
    xs = np.stack([g[0] for g in got])
    w = torch.randn(got[0][1].shape, generator=torch.Generator().manual_seed(7)).numpy()
    for r, (x, y, dx) in enumerate(got):
        if op in ("psum", "pmean"):
            n = 1 if op == "psum" else 4
            want_y, want_dx = xs.sum(0) / n, w / n
        elif op == "pmax":
            want_y = xs.max(0)
            want_dx = w * (x == want_y)
        elif op == "all_gather":          # rank r is index r of ("data", "tensor")
            want_y = np.concatenate(list(xs), axis=1)
            want_dx = w[:, 6 * r:6 * (r + 1)]
        else:                             # the tensor axis pairs ranks 2d and 2d + 1
            d, t = divmod(r, 2)
            peers = xs[2 * d:2 * d + 2]
            want_y = np.concatenate([peers[j][2 * t:2 * t + 2] for j in range(2)])
            want_dx = np.concatenate([w[2 * t:2 * t + 2]] * 2) / 4
        np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, want_dx, rtol=1e-6, atol=1e-7)


def _slice(a, slices):
    return a[tuple(slice(*s) for s in slices)]


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


# jamba's gradient shards are held by the global norm and the step alone:
# its SSD leaves' (A_log) gradients cancel to ~1e-4 of their terms, and the
# JAX package's own fp32 gradient of layer 0's A_log is 1.04e-5 of the
# leaf's max off its float64 value, so a 1e-5 bound there holds the
# reference's rounding, not the port's
NOISY_GRADS = ("jamba-v0.1-52b",)


@pytest.mark.parametrize("case", CASES + SEQ_CASES, ids=ids + seq_ids)
def test_loss_and_gradient_match_the_reference_mesh(runs, case):
    """A "seq" case (the sequence-parallel rule) against the reference's
    case on the same mesh: a norm weight's gradient on a sequence shard is
    the share of the rank's own tokens, summed over the tensor axis with
    the rest."""
    _, ref, port = runs
    want = ref[case[:3]]
    for rank in _ranks(case):
        got = port[rank]["cases"][case]
        assert got["loss"] == pytest.approx(want["loss"][rank], rel=TOL), rank
        assert got["aux"] == pytest.approx(want["aux"][rank], rel=TOL, abs=1e-7), rank
        if case[0] in NOISY_GRADS:
            continue
        errs = [_rel(g, _slice(w, s)) for g, w, s in zip(got["grads"], want["grads"],
                                                          got["slices"])]
        assert len(errs) == len(want["grads"]) and max(errs) <= TOL, (rank, max(errs))


@pytest.mark.parametrize("case", CASES + SEQ_CASES, ids=ids + seq_ids)
def test_global_norm_of_the_shards_is_the_reference_gradient_s(runs, case):
    """``global_norm`` over the rank's reduced shards (each leaf's squares
    summed over the axes that split it, a leaf held alike counted once)
    against the norm of the reference's global gradient: the clip scale."""
    _, ref, port = runs
    for rank in _ranks(case):
        assert port[rank]["cases"][case]["gnorm"] == pytest.approx(ref[case[:3]]["gnorm"],
                                                                   rel=TOL), rank


def test_the_data_split_aux_is_the_reference_s(runs):
    """Where the data axis splits the batch the ranks' losses differ by
    their shards' aux, as the devices' do; elsewhere they are one value."""
    _, ref, port = runs
    for case in CASES:
        losses = [port[r]["cases"][case]["loss"] for r in _ranks(case)]
        split = case[1][0] > 1 and tiny_config(case[0]).moe is not None
        assert (len(set(losses)) > 1) == split, (case, losses)
        assert (len(set(ref[case]["loss"])) > 1) == split, (case, ref[case]["loss"])


def _adamw_err(before, after, m, v, *, lr, step, weight_decay=0.1, b1=0.9, b2=0.95, eps=1e-8):
    """The worst |new parameter - AdamW's| over its tolerance: AdamW in
    float64 from the parameters before and the moments after the step."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    worst = 0.0
    for p0, p1, mm, vv in zip(before, after, m, v):
        p0, p1, mm, vv = (np.asarray(t, np.float64) for t in (p0, p1, mm, vv))
        delta = (mm / bc1) / (np.sqrt(vv / bc2) + eps) + weight_decay * p0
        want = p0 - lr * delta
        tol = ADAMW_RTOL * lr * (1 + np.abs(delta)) + 2.0 ** -22 * np.maximum(np.abs(p0),
                                                                              np.abs(want))
        worst = max(worst, float((np.abs(p1 - want) / tol).max()))
    return worst


# the share of a leaf's elements whose int8 rounding may fall either way:
# those whose gradient lies within TOL of its max of a rounding boundary,
# TOL * 127 of a quantum on either side
FLIP_SHARE = 2 * 127 * TOL


def _within(a, b, whole, tol, flip, name):
    """|a - b| within ``tol`` of the max of ``whole`` (the global leaf b is
    a slice of), but an element whose int8 rounding fell the other way (at
    most ``flip`` of that max off; FLIP_SHARE of the elements, or one)."""
    err, top = np.abs(a - b), max(float(np.abs(whole).max()), 1e-30)
    off = err > tol * top
    assert off.sum() <= max(1, FLIP_SHARE * off.size), (name, int(off.sum()), off.size)
    assert (err[off] <= (tol + flip) * top).all(), name


# phase 12 (c)'s bounds on AdamW's moments, relative to the global leaf's
# max: m within TOL plus one step of the leaf's int8 quantizer (an element
# on a rounding boundary may round either way, and each such element moves
# the global norm, so the clip scale of every element), v (quadratic in the
# gradient) within twice TOL plus 253 / 127**2
MOMENT_TOL = {"m": TOL + 1 / 127, "v": 2 * TOL + 253 / 127 ** 2}
# the error feedback is the residual before the clip, at most half a
# quantum (max |err| ~ max |g| / 254): the gradient's TOL is 254 TOL of it,
# and an element that rounded the other way moves a whole quantum, twice
# its max
ERR_TOL, ERR_FLIP = 254 * TOL, 2.02


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_step_with_microbatches_and_int8_gradients_matches(runs, case):
    _, ref, port = runs
    want = ref[case]
    for rank in _ranks(case):
        got = port[rank]["cases"][case]
        assert got["step_loss"] == pytest.approx(want["step_loss"][rank], rel=TOL), rank
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6) and got["step"] == 1
        for name, tol in MOMENT_TOL.items():
            for i, (a, w, s) in enumerate(zip(got[name], want[name], got["slices"])):
                err = float(np.abs(a - _slice(w, s)).max())
                assert err <= tol * float(np.abs(w).max()), (rank, name, i, err)
        for i, (a, w, s) in enumerate(zip(got["err"], want["err"], got["slices"])):
            _within(a, _slice(w, s), w, ERR_TOL, ERR_FLIP, (rank, "err", i))
        assert _adamw_err(got["before"], got["after"], got["m"], got["v"], lr=got["lr"],
                          step=got["step"]) <= 1.0, rank


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_every_rank_holds_only_its_shards(runs, case):
    """Parameters, moments and error feedback: each leaf the rank's slice
    of the global leaf, and the slices of the ranks tile it."""
    params, _, port = runs
    leaves = tree_leaves(params[case[0]])
    for rank in _ranks(case):
        got = port[rank]["cases"][case]
        for name in ("after", "m", "v", "err"):
            assert [a.shape for a in got[name]] == [_slice(w, s).shape for w, s in
                                                   zip(leaves, got["slices"])], (rank, name)
    n = int(np.prod(case[1]))
    mesh_size = np.prod(case[1])
    for i, w in enumerate(leaves):
        covered = np.zeros(w.shape, np.int64)
        for rank in range(n):
            _slice(covered, port[rank]["cases"][case]["slices"][i])[...] += 1
        sizes = [np.prod([b - a for a, b in port[r]["cases"][case]["slices"][i]])
                 for r in range(n)]
        # each element held by the same number of ranks: those the leaf is not split over
        assert covered.min() == covered.max() == mesh_size * sizes[0] // max(w.size, 1), i


def test_resume_on_the_mesh_equals_the_uninterrupted_run(runs):
    _, _, port = runs
    for rank in range(4):
        t = port[rank]["trainer"]
        assert t["crashed"] and t["crash_losses"] == t["losses"][:2], rank
        assert t["start"] == 2 and t["resumed_losses"] == t["losses"][2:], rank
        for a, b in zip(t["resumed_after"], t["full_after"]):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(port[0]["trainer"]["losses"]).all()


def test_a_mesh_checkpoint_restores_unsharded_to_the_gathered_tree(runs):
    _, _, port = runs
    u = port[0]["trainer"]["unsharded"]
    assert u["start"] == 4 and u["step"] == 4 and u["step_count"] == 4
    assert u["params_equal"] and u["moments_equal"]
    assert all("unsharded" not in port[r]["trainer"] for r in range(1, 4))
