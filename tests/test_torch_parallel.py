"""The port's data parallelism against the JAX package's and against one
process: the sharded train and eval steps (``tests/test_parallel.py``), under
``grad_accum`` 2, for classification and with distillation; the
``HostShardedBatcher`` (``tests/test_data_pipeline.py``); the window-axis
forward (``tests/test_window_shard.py``); and the inferencer sharded over a
device list.

Two gloo ranks on the CPU start ONCE for the module (``ranks``): each runs
every step case on its rows of the same global batches, in float32 and with
the model in float64, and saves what it read; the tests hold those against
JAX's sharded step on a 2-device mesh and against the port's one-process
step on the global batch. Augmentation is off and dropout 0 there: each rank
draws its own masks (``parallel/mesh.py``).

Where the claim is exact: two ranks sum the same numbers as one process in
another order, so in float32 their gradients part by rounding, and on these
draws that noise floor lies above any tight bound (one process against
itself with the clouds permuted: ``test_float32_noise_floor_of_the_step``
prints it; 1.3e-3 of the largest |g| of
``encoder.input_tnet.trunk.mlp_0.dense.weight`` on one machine, 0.17 on the
worst parameter). So the gradients, the running statistics and
``grad_norm`` are held in float64, to 1e-10 of their scale; float32 keeps
the bit-identical ranks, the loss to 1e-5 and the equal confusion.

The ranks import this module, so JAX is imported inside the fixtures and
tests that use it: a rank needs torch alone."""

import copy

import numpy as np
import pytest
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import load_flax_variables
from ampnet_tpu_torch.data.pipeline import HostShardedBatcher, PaddedBatcher
from ampnet_tpu_torch.infer.tiled import TiledInferencer
from ampnet_tpu_torch.models.amp import AMPNetClassifier, AMPNetSegmenter
from ampnet_tpu_torch.parallel.mesh import (
    make_sharded_step_fns,
    rank_rows,
    replicate_state,
    shard_batch,
    spawn_ranks,
)
from ampnet_tpu_torch.parallel.window_shard import make_grid
from ampnet_tpu_torch.parallel.window_shard import (
    make_window_sharded_forward as make_port_window_forward,
)
from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns

LR = 1e-3
NOISE = 1e-7
BATCH = (4, 3, 64)  # clouds, windows, points: 2 clouds a rank, 1 a micro-batch under accum 2
UNEVEN = (6, 3, 64)  # --batch_size 6 --grad_accum 2 on 2 ranks: shares of 2 and 1
EXACT = 1e-10  # float64 gradients, statistics and grad_norm, of their scale
CLS_WEIGHTS = (0.3, 0.7)


def make_batch(seed=0, shape=BATCH):
    """[B, W, N, 9] points with a scale and an offset per window, labels in
    0..4, the last window of the last cloud replicate-padded (labels −1)."""
    rng = np.random.default_rng(seed)
    b, w, n = shape
    pts = rng.normal(size=(b, w, n, 9)).astype(np.float32) * 0.5
    pts *= rng.uniform(0.2, 2.0, size=(b, w, 1, 1)).astype(np.float32)
    pts[..., :3] += rng.uniform(-1, 1, size=(b, w, 1, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(b, w, n)).astype(np.int32)
    pts[-1, -1] = pts[-1, -2]
    labels[-1, -1] = -1
    return {"points": pts, "labels": labels, "centroids": pts[..., :2].mean(axis=2)}


def cls_batch():
    b = make_batch(seed=1)
    b["labels"][:] = 0  # whole-cloud task: the windows carry no per-point labels
    b["cls_label"] = np.array([0, 1, 1, -1], np.int32)  # the last cloud a pad
    return b


def cfg_for(**train):
    return AMPNetConfig(model=ModelConfig(dropout=0.0), train=TrainConfig(**train))


def tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if isinstance(v, np.ndarray)}


def seg_model(variables, remat=False):
    model = AMPNetSegmenter(ModelConfig(dropout=0.0, remat=remat))
    load_flax_variables(model, variables)
    return model


def cls_model():
    return AMPNetClassifier(ModelConfig(dropout=0.0), num_out=2, num_windows=BATCH[1],
                            generator=torch.Generator().manual_seed(3))


def teacher(dtype=torch.float32):
    model = AMPNetSegmenter(ModelConfig(), generator=torch.Generator().manual_seed(7))
    return [(cfg_for(), model.to(dtype))]


def step_cases(variables, dtype=torch.float32):
    """(name, model maker, config, steps maker, global batch, grad_accum) of
    every step case; ``steps(dp)`` builds the case's steps under ``dp``
    (None: one process). "remat" is "seg" with the encoder recomputed in the
    backward pass (its BatchNorms all-reduce again there); "uneven" splits
    each micro-batch of 3 clouds 2 + 1 over the ranks, "empty" each
    micro-batch of 1 cloud 1 + 0."""
    distill = cfg_for(distill_alpha=0.5, distill_temp=2.0)
    accum = lambda dp: make_step_fns(cfg_for(), augment=False, grad_accum=2, dp=dp)
    return [
        ("seg", lambda: seg_model(variables), cfg_for(),
         lambda dp: make_step_fns(cfg_for(), augment=False, dp=dp), make_batch(), 1),
        ("accum", lambda: seg_model(variables), cfg_for(grad_accum=2),
         lambda dp: make_step_fns(cfg_for(), augment=False, grad_accum=2, dp=dp), make_batch(), 2),
        ("cls", cls_model, cfg_for(),
         lambda dp: make_cls_step_fns(cfg_for(), np.asarray(CLS_WEIGHTS), dp=dp, augment=False),
         cls_batch(), 1),
        ("distill", lambda: seg_model(variables), distill,
         lambda dp: make_step_fns(distill, augment=False, teacher=teacher(dtype), dp=dp),
         make_batch(), 1),
        ("remat", lambda: seg_model(variables, remat=True), cfg_for(),
         lambda dp: make_step_fns(cfg_for(), augment=False, dp=dp), make_batch(), 1),
        ("uneven", lambda: seg_model(variables), cfg_for(grad_accum=2), accum,
         make_batch(seed=2, shape=UNEVEN), 2),
        ("empty", lambda: seg_model(variables), cfg_for(grad_accum=2), accum,
         make_batch(seed=3, shape=(2, 3, 64)), 2),
    ]


def cast(batch, dtype):
    """The batch as tensors, its float fields in ``dtype``."""
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in tensors(batch).items()}


def run_case(model, cfg, steps, batch, dp=None, grad_accum=1, dtype=torch.float32):
    """One train step and, from the same starting weights, one eval step:
    what each read, as numpy; the model and the batch in ``dtype``."""
    model = model.to(dtype)
    state = create_train_state(cfg, model, 1, "cpu")
    fresh = copy.deepcopy(model)
    if dp is not None:
        replicate_state(state, dp)
        batch = shard_batch(batch, dp, grad_accum)
    train_step, eval_step = steps(dp)
    m = train_step(state, cast(batch, dtype))
    out = {k: v.numpy() for k, v in m.items()}
    out["grads"] = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()}
    out["stats"] = {n: b.numpy().copy() for n, b in state.model.named_buffers()}
    eval_state = create_train_state(cfg, fresh, 1, "cpu")
    em, preds = eval_step(eval_state, cast(batch, dtype))
    out["eval"] = {k: v.numpy() for k, v in em.items()}
    out["preds"] = preds.numpy()
    return out


def all_cases(variables, dp=None):
    """Every step case in float32 (``<name>``) and float64 (``<name>64``)."""
    res = {}
    for dtype, tag in ((torch.float32, ""), (torch.float64, "64")):
        for name, make, cfg, steps, batch, accum in step_cases(variables, dtype):
            res[name + tag] = run_case(make(), cfg, steps, batch, dp, accum, dtype)
    return res


def rank_worker(dp, variables, out_dir):
    """Every step case on this rank's rows; saved as ``rank<r>.pt``."""
    torch.set_num_threads(2)
    torch.save(all_cases(variables, dp), f"{out_dir}/rank{dp.rank}.pt")


def jax_init(points, centroids, pad):
    """(JAX segmenter, its Flax init on these inputs as numpy), dropout 0."""
    import jax

    from ampnet_tpu.core.config import ModelConfig as JModelConfig
    from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter

    jm = JSegmenter(JModelConfig(dropout=0.0))
    init = jax.jit(lambda key, p, c, m: jm.init(key, p, c, m, train=False))
    return jm, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), points, centroids, pad))


@pytest.fixture(scope="module")
def setup():
    """(JAX segmenter, a Flax init perturbed by seeded noise of 0.02, as numpy)."""
    import jax

    batch = make_batch()
    jm, v = jax_init(batch["points"], batch["centroids"], (batch["labels"] == -1).all(-1))
    rng = np.random.default_rng(5)
    v = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.02).astype(a.dtype), v)
    return jm, v


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Both ranks' results, from one spawn of 2 gloo ranks."""
    out = tmp_path_factory.mktemp("ranks")
    spawn_ranks(rank_worker, 2, device="cpu", args=(setup[1], str(out)))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def one_process(setup):
    """Every step case in one process on the global batch."""
    return all_cases(setup[1])


def run_jax_sharded(setup, batch, grad_accum=1):
    """JAX's sharded train and eval steps on a 2-device mesh (augment off)
    on ``batch``: (train metrics, eval metrics, predictions) as numpy."""
    import jax
    import jax.numpy as jnp

    from ampnet_tpu.core.config import AMPNetConfig as JConfig
    from ampnet_tpu.core.config import ModelConfig as JModelConfig
    from ampnet_tpu.parallel.mesh import make_mesh
    from ampnet_tpu.parallel.mesh import make_sharded_step_fns as j_make_sharded_step_fns
    from ampnet_tpu.parallel.mesh import replicate_state as j_replicate_state
    from ampnet_tpu.parallel.mesh import shard_batch as j_shard_batch
    from ampnet_tpu.train.state import AMPTrainState, clone_state, multistep_adam

    from ampnet_tpu.core.config import TrainConfig as JTrainConfig

    jm, v = setup
    jcfg = JConfig(model=JModelConfig(dropout=0.0), train=JTrainConfig(grad_accum=grad_accum))
    mesh = make_mesh(2)
    state = AMPTrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=multistep_adam(LR, (150,), 0.5, 1), rng=jax.random.PRNGKey(1),
        epoch=jnp.zeros((), jnp.int32), lr_scale=jnp.ones((), jnp.float32))
    train, evaluate = j_make_sharded_step_fns(jcfg, mesh, augment=False)
    batch = j_shard_batch({k: jnp.asarray(a) for k, a in batch.items()}, mesh)
    em, preds = evaluate(j_replicate_state(state, mesh), batch)
    _, m = train(j_replicate_state(clone_state(state), mesh), batch)
    return (jax.tree.map(np.asarray, m), jax.tree.map(np.asarray, em), np.asarray(preds))


@pytest.fixture(scope="module")
def jax_sharded(setup):
    return run_jax_sharded(setup, make_batch())


def assert_exact(one, r):
    """A float64 step of two ranks against one process: the summed
    gradients, the running statistics and ``grad_norm`` to EXACT of their
    scale. A gradient that is zero in exact arithmetic (a bias that a
    batch-statistics BatchNorm cancels) is held to |g| <= 1e-12 on both."""
    for name, g_ref in one["grads"].items():
        g, scale = r["grads"][name], np.abs(g_ref).max()
        if scale < NOISE:
            assert max(scale, np.abs(g).max()) <= 1e-12, name
        else:
            np.testing.assert_allclose(g, g_ref, atol=EXACT * scale, rtol=0, err_msg=name)
    for name, s in one["stats"].items():
        np.testing.assert_allclose(r["stats"][name], s, atol=EXACT * max(np.abs(s).max(), 1.0),
                                   rtol=0, err_msg=name)
    if "grad_norm" in one:  # read after the gradients are summed
        assert float(r["grad_norm"]) == pytest.approx(float(one["grad_norm"]), rel=EXACT)


def worst_grad_gap(a, b) -> float:
    """The largest gradient difference of two runs, of each parameter's largest |g|."""
    return max(float(np.abs(a[n] - g).max() / max(np.abs(g).max(), NOISE)) for n, g in b.items())


def test_rank_rows_split_each_micro_batch():
    assert [list(rank_rows(8, 2, r)) for r in range(2)] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [list(rank_rows(8, 2, r, grad_accum=2)) for r in range(2)] == [[0, 1, 4, 5],
                                                                         [2, 3, 6, 7]]
    # unequal shares of each micro-batch of 3, as np.array_split cuts them
    assert [list(rank_rows(6, 2, r, grad_accum=2)) for r in range(2)] == [[0, 1, 3, 4], [2, 5]]
    assert [list(rank_rows(2, 2, r, grad_accum=2)) for r in range(2)] == [[0, 1], []]
    with pytest.raises(ValueError, match="equal micro-batches"):
        rank_rows(5, 2, 0, grad_accum=2)


def test_sharded_step_matches_jax_sharded_step(ranks, jax_sharded):
    jm, _, _ = jax_sharded
    for r in ranks:
        assert float(r["seg"]["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        np.testing.assert_array_equal(r["seg"]["confusion"],
                                      np.asarray(jm["confusion"]).astype(np.int64))


def assert_two_ranks_equal_one_process(case, ranks, one_process):
    """float32: both ranks read the same numbers, bit for bit, and the loss
    (1e-5) and the confusion of one process; float64: the summed gradients,
    the running statistics and ``grad_norm`` of one process (``assert_exact``)."""
    one = one_process[case]
    r0, r1 = ranks[0][case], ranks[1][case]
    for key in r0:
        if key not in ("grads", "stats", "eval", "preds"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    assert float(r0["loss"]) == pytest.approx(float(one["loss"]), rel=1e-5)
    np.testing.assert_array_equal(r0["confusion"], one["confusion"])
    if case == "distill":
        assert float(r0["distill_loss"]) == pytest.approx(float(one["distill_loss"]), rel=1e-5)
    for r in (ranks[0][case + "64"], ranks[1][case + "64"]):
        assert_exact(one_process[case + "64"], r)


@pytest.mark.parametrize("case", ["seg", "accum", "cls", "distill"])
def test_two_ranks_equal_one_process_on_the_global_batch(case, ranks, one_process):
    """Loss, the summed gradients, the BatchNorm running statistics and the
    confusion of 2 ranks equal one process on the global batch; both ranks
    read the same numbers, bit for bit."""
    assert_two_ranks_equal_one_process(case, ranks, one_process)


def test_remat_under_two_ranks_equals_the_plain_sharded_step(ranks):
    """The recompute runs the encoder's BatchNorm all-reduces again in the
    backward pass, on every rank in the same order: each rank's step equals
    its plain step bit for bit, in float32 and float64."""
    for r in ranks:
        for tag in ("", "64"):
            plain, remat = r["seg" + tag], r["remat" + tag]
            for key in ("loss", "confusion", "grad_norm"):
                np.testing.assert_array_equal(remat[key], plain[key], err_msg=key)
            for kind in ("grads", "stats"):
                for name, a in plain[kind].items():
                    np.testing.assert_array_equal(remat[kind][name], a, err_msg=name)


def test_float32_noise_floor_of_the_step(setup, one_process):
    """One process against itself on the same clouds in another order: in
    float64 the gradients agree to EXACT, in float32 they part by rounding
    (printed: the floor under any float32 bound on two ranks' gradients)."""
    name, make, cfg, steps, batch, _ = step_cases(setup[1])[0]
    perm, first = [1, 0, 3, 2], "encoder.input_tnet.trunk.mlp_0.dense.weight"
    permuted = {k: v[perm] for k, v in batch.items()}
    assert_exact(one_process[name + "64"],
                 run_case(make(), cfg, steps, permuted, dtype=torch.float64))
    ref, again = one_process[name]["grads"], run_case(make(), cfg, steps, permuted)["grads"]
    worst = worst_grad_gap(again, ref)
    print(f"float32 noise floor, clouds permuted {perm}: "
          f"{worst_grad_gap({first: again[first]}, {first: ref[first]}):.3g} of max|g| at "
          f"{first}, {worst:.3g} at the worst parameter")
    assert 0.0 < worst < 1.0


@pytest.mark.parametrize("case", ["uneven", "empty"])
def test_unequal_rank_shares_equal_one_process(case, ranks, one_process):
    """Micro-batches that do not split evenly over the ranks: 2 + 1 clouds,
    and 1 + 0 (rank 1 holds nothing, and still joins every all-reduce)."""
    assert_two_ranks_equal_one_process(case, ranks, one_process)
    if case == "empty":
        assert ranks[1][case]["preds"].shape[0] == 0


def test_unequal_rank_shares_match_jax_sharded_step(setup, ranks):
    """``--batch_size 6 --grad_accum 2`` on 2 ranks against JAX's sharded
    step on a 2-device mesh (which shards the global batch as one program):
    the loss and the confusion; the eval step's predictions."""
    jm, jem, jpreds = run_jax_sharded(setup, make_batch(seed=2, shape=UNEVEN), grad_accum=2)
    for r in ranks:
        assert float(r["uneven"]["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        np.testing.assert_array_equal(r["uneven"]["confusion"],
                                      np.asarray(jm["confusion"]).astype(np.int64))
        assert float(r["uneven"]["eval"]["ce_loss"]) == pytest.approx(float(jem["ce_loss"]),
                                                                      rel=1e-5)
    preds = np.concatenate([r["uneven"]["preds"] for r in ranks])
    np.testing.assert_array_equal(preds, np.asarray(jpreds)[[0, 1, 3, 4, 2, 5]])


def test_accum_rows_are_not_the_contiguous_blocks(setup, one_process):
    """Under grad_accum 2 each micro-batch's BatchNorm runs over the global
    micro-batch: the contiguous half of the batch per rank gives other
    gradients, so the row rule is what the test above holds."""
    variables = setup[1]
    batch = make_batch()
    a = run_case(seg_model(variables), cfg_for(), lambda dp: make_step_fns(
        cfg_for(), augment=False, grad_accum=2), {k: v[[0, 2, 1, 3]] for k, v in batch.items()})
    assert worst_grad_gap(a["grads"], one_process["accum"]["grads"]) > 1e-3


def test_eval_step_predictions_match_jax(ranks, one_process, jax_sharded):
    _, jem, jpreds = jax_sharded
    preds = np.concatenate([r["seg"]["preds"] for r in ranks])
    np.testing.assert_array_equal(preds, np.asarray(jpreds))
    np.testing.assert_array_equal(preds, one_process["seg"]["preds"])
    for r in ranks:
        assert float(r["seg"]["eval"]["ce_loss"]) == pytest.approx(float(jem["ce_loss"]),
                                                                   rel=1e-5)
        np.testing.assert_array_equal(r["seg"]["eval"]["confusion"],
                                      one_process["seg"]["eval"]["confusion"])


# -- HostShardedBatcher --------------------------------------------------------


class _IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {
            "points": rng.normal(size=(2, 16, 9)).astype(np.float32),
            "labels": np.full((2, 16), i % 5, np.int32),
            "centroids": rng.normal(size=(2, 2)).astype(np.float32),
            "name": f"s{i}",
        }


@pytest.mark.parametrize("n_points", [16, 12])  # as stored, and resampled by each host
def test_host_sharded_batcher_matches_jax(n_points):
    from ampnet_tpu.data.pipeline import HostShardedBatcher as JHostShardedBatcher

    n, gb, hosts = 23, 8, 4
    ds = _IndexDataset(n)
    per_host = []
    for h in range(hosts):
        kw = dict(host_id=h, host_count=hosts, n_points=n_points, max_windows=2, seed=3)
        ours = list(HostShardedBatcher(ds, gb, **kw))
        theirs = list(JHostShardedBatcher(ds, gb, prefetch=0, **kw))
        assert len(ours) == len(theirs) == n // gb
        for a, b in zip(ours, theirs):
            assert a["names"] == b["names"]
            for k in ("points", "labels", "centroids"):
                np.testing.assert_array_equal(a[k], b[k])
        per_host.append(ours)
    single = list(PaddedBatcher(ds, gb, n_points=16, max_windows=2, seed=3))
    for b, whole in enumerate(single):
        assert sum((p[b]["names"] for p in per_host), []) == whole["names"]


def test_host_sharded_batcher_defaults_and_refusals():
    b = HostShardedBatcher(_IndexDataset(8), 4, n_points=16, max_windows=2)
    assert (b.host_id, b.host_count, b.batch_size) == (0, 1, 4)
    with pytest.raises(ValueError, match="not divisible"):
        HostShardedBatcher(_IndexDataset(8), 6, host_id=0, host_count=4)
    with pytest.raises(ValueError, match="drop_last"):
        HostShardedBatcher(_IndexDataset(8), 4, host_id=0, host_count=2, drop_last=False)


# -- the window-axis forward ---------------------------------------------------


@pytest.fixture(scope="module")
def window_inputs():
    """Four clouds of 8 windows x 64 points (the last window padded) and the
    JAX segmenter's init on them, as in tests/test_window_shard.py."""
    rng = np.random.default_rng(0)
    b, w, n = 4, 8, 64
    pts = (rng.normal(size=(b, w, n, 9)) * 0.5).astype(np.float32)
    cent = rng.normal(size=(b, w, 2)).astype(np.float32)
    pad = np.zeros((b, w), bool)
    pad[:, w - 1] = True
    return (pts, cent, pad, *jax_init(pts, cent, pad))


@pytest.mark.parametrize("n_data,n_window", [(2, 4), (1, 8), (4, 2)])
def test_window_sharded_forward_matches_jax(n_data, n_window, window_inputs):
    import jax.numpy as jnp

    from ampnet_tpu.core.config import AMPNetConfig as JConfig
    from ampnet_tpu.core.config import ModelConfig as JModelConfig
    from ampnet_tpu.parallel.window_shard import make_2d_mesh, make_window_sharded_forward
    from ampnet_tpu.parallel.window_shard import shard_cloud_batch

    pts, cent, pad, jm, variables = window_inputs
    b = max(2, n_data)
    pts, cent, pad = pts[:b], cent[:b], pad[:b]
    jcfg = JConfig(model=JModelConfig(dropout=0.0))
    mesh = make_2d_mesh(n_data, n_window)
    sharded = shard_cloud_batch({"points": jnp.asarray(pts), "centroids": jnp.asarray(cent),
                                 "pad": jnp.asarray(pad)}, mesh)
    ref = np.asarray(make_window_sharded_forward(jm, jcfg, mesh)(
        variables, sharded["points"], sharded["centroids"], sharded["pad"]))

    model = AMPNetSegmenter(ModelConfig(dropout=0.0))
    load_flax_variables(model, variables)
    fwd = make_port_window_forward(model, make_grid(n_data, n_window, ["cpu"] * 8))
    out = fwd(torch.from_numpy(pts), torch.from_numpy(cent), torch.from_numpy(pad))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    with torch.inference_mode():
        single = model(torch.from_numpy(pts), torch.from_numpy(cent), torch.from_numpy(pad))[0]
    np.testing.assert_allclose(out.numpy(), single.numpy(), atol=2e-5)


def test_window_grid_refusals():
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_grid(2, 2, ["cpu"] * 3)
    fwd = make_port_window_forward(AMPNetSegmenter(ModelConfig()), make_grid(1, 2, ["cpu"] * 2))
    with pytest.raises(ValueError, match="do not split"):
        fwd(torch.zeros(1, 3, 8, 9), torch.zeros(1, 3, 2), torch.zeros(1, 3, dtype=torch.bool))


# -- the inferencer over a device list ------------------------------------------


def test_sharded_inferencer_equals_each_shard_on_one_device():
    """Each bucket's clouds split into contiguous shards, one per device, each
    with its own copy of the prepared chains (``fused``: the kernel's plain
    version here); a short bucket is padded with copies of its first cloud
    (seed 0)."""
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(2)).eval()
    rng = np.random.default_rng(4)
    clouds = [rng.normal(size=(300, 9)).astype(np.float32) for _ in range(4)]
    one = TiledInferencer(copy.deepcopy(model), cfg, n_points=64, max_clusters=3,
                          backend="fused", device="cpu")
    two = TiledInferencer(model, cfg, n_points=64, max_clusters=3, backend="fused",
                          devices=["cpu", "cpu"])
    handle = two.dispatch_many(clouds)
    assert [len(idxs) for idxs, _ in handle["pending"]] == [2, 2]
    got = two.fetch_many(handle)
    want = one.predict_many(clouds[:2], seeds=[0, 1]) + one.predict_many(clouds[2:], seeds=[2, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # three clouds: the second shard holds cloud 2 and a copy of cloud 0
    got = two.predict_many(clouds[:3], return_probs=True)
    want = one.predict_many([clouds[2], clouds[0]], seeds=[2, 0], return_probs=True)[0]
    np.testing.assert_array_equal(got[2][0], want[0])
    np.testing.assert_array_equal(got[2][1], want[1])
    assert two.predict(clouds[3], seed=3).shape == (300,)
