"""The port's checkpoints, trainer and ``train`` command against the JAX
package: ``state.pt`` round trips bitwise, ``meta.json`` equals the JAX
CheckpointManager's, a JAX train state carries into the port (and back)
through the weight bridge and then steps alike, ``Trainer.fit`` writes and
resumes its best checkpoint, and ``train`` / ``serve`` run on the CPU."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.checkpoint import CheckpointManager as JCheckpointManager
from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.train.state import AMPTrainState, clone_state, multistep_adam
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu_torch.cli.main import build_parser, main, make_server
from ampnet_tpu_torch.core import checkpoint as ckpt_mod
from ampnet_tpu_torch.core.checkpoint import CheckpointManager, load_model, read_payload
from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import (
    _get,
    _leaves,
    flax_variables,
    load_flax_variables,
    load_optax_adam_state,
    optax_adam_state,
)
from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher
from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list
from ampnet_tpu_torch.data.pipeline import PaddedBatcher
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns
from ampnet_tpu_torch.train.trainer import Trainer
from test_torch_train import (
    LR,
    _perturbed,
    assert_params_after_step,
    assert_stats_close,
    make_batch,
    tensors,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = dict(task="segmentation", accuracy=0.75, epochs_since_improvement=2,
            weighing_method="EFS", batch_size=2, learning_rate=LR, number_of_points=64,
            extra_meta={"best_val_loss": 1.25})


def payloads_equal(a, b):
    """Two ``state.pt`` payloads hold the same bits in every tensor."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            payloads_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def stepped_state(seed=0, steps=1, cfg=None):
    cfg = cfg or AMPNetConfig(model=ModelConfig(dropout=0.0))
    model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(cfg, model, 1, "cpu")
    step, _ = make_step_fns(cfg)
    for s in range(steps):
        step(state, tensors(make_batch(seed=s, shape=(2, 3, 32))))
    return cfg, state


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX state after one step, its step function, and the batch."""
    batch = make_batch()
    jcfg = JConfig(model=JModelConfig(dropout=0.0))
    jm = JSegmenter(jcfg.model)
    pad = jnp.asarray((batch["labels"] == -1).all(-1))
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                           jnp.asarray(batch["centroids"]), pad, train=False), 5, 0.02)
    state = AMPTrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=multistep_adam(LR, (150,), 0.5, 1), rng=jax.random.PRNGKey(1),
        epoch=jnp.zeros((), jnp.int32), lr_scale=jnp.ones((), jnp.float32))
    step, _ = j_make_step_fns(jcfg, augment=False)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    state, _ = step(state, jb)
    return jcfg, step, state, batch


# -- state.pt ----------------------------------------------------------------------


def test_checkpoint_round_trips_bitwise(tmp_path):
    cfg, state = stepped_state(steps=2)
    state.epoch, state.lr_scale = 3, 0.25
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    path = mgr.save("best", state, config_json=cfg.to_json(), **META)
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    saved = read_payload(path)
    assert int(saved["opt_state"]["count"]) == 2 and saved["opt_state"]["count"].dtype == torch.int32
    _, fresh = stepped_state(seed=9, steps=0, cfg=cfg)
    _, meta = mgr.restore("best", fresh)
    assert meta["best_val_loss"] == 1.25
    assert (fresh.step, fresh.epoch, fresh.lr_scale) == (2, 3, 0.25)
    for name, t in state.model.state_dict().items():  # params and buffers
        assert torch.equal(fresh.model.state_dict()[name], t), name
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert float(a["step"]) == float(b["step"]) == 2.0
    # and the restored state takes the same next step as the original
    batch = tensors(make_batch(seed=7, shape=(2, 3, 32)))
    step, _ = make_step_fns(cfg)
    step(state, batch)
    step(fresh, batch)
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name


def test_async_save_writes_the_snapshot_not_later_steps(tmp_path):
    cfg, state = stepped_state(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    sync_path = mgr.save("sync", state, **META)
    mgr.save_async("async", state.snapshot(copy=True), **META)
    step, _ = make_step_fns(cfg)
    for s in range(2):  # in-place updates after the snapshot
        step(state, tensors(make_batch(seed=10 + s, shape=(2, 3, 32))))
    mgr.wait()
    payloads_equal(read_payload(sync_path), mgr.load_payload("async"))
    assert mgr.load_meta("async") == mgr.load_meta("sync")


def test_async_save_error_is_raised_by_wait_and_by_the_next_save(tmp_path, monkeypatch):
    _, state = stepped_state(steps=0)
    mgr = CheckpointManager(str(tmp_path))

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", fail)
    mgr.save_async("x", state.snapshot(), **META)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    mgr.save_async("x", state.snapshot(), **META)
    writer = mgr._writer  # None once the failed write has finished
    if writer is not None:
        writer.join(timeout=60)
    with pytest.raises(RuntimeError, match="previous async checkpoint write failed"):
        mgr.save_async("y", state.snapshot(), **META)
    mgr.wait()
    assert not mgr.exists("x")


def test_meta_matches_the_jax_checkpoint_manager(tmp_path, jax_setup):
    jcfg, _, jstate, _ = jax_setup
    cfg = AMPNetConfig()
    assert cfg.to_json() == JConfig().to_json()
    JCheckpointManager(str(tmp_path / "jax")).save("best", jstate, config_json=JConfig().to_json(),
                                                   **META)
    _, state = stepped_state(steps=0)
    CheckpointManager(str(tmp_path / "port")).save("best", state, config_json=cfg.to_json(),
                                                   **META)
    metas = [json.loads((tmp_path / d / "best" / "meta.json").read_text()) for d in ("jax", "port")]
    assert metas[0] == metas[1]
    assert metas[1]["schema_version"] == 1
    assert metas[1]["config"]["data"]["geom_k"] == 24
    assert metas[1]["config"]["data"]["geom_radius_norm"] == "absolute"
    # a JAX orbax directory is refused with a clear message
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(str(tmp_path / "jax")).load_meta("best")
    with pytest.raises(ValueError, match="orbax"):
        load_model(str(tmp_path / "jax" / "best"), device="cpu")


def test_jax_state_carries_into_the_port_and_steps_alike(jax_setup):
    """A JAX state after one step → the port through the bridge (weights,
    BatchNorm statistics, Adam's count/mu/nu) → one more step in both."""
    _, jstep, jstate, batch = jax_setup
    jstate_np = jax.tree.map(np.asarray, jstate)
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    model = AMPNetSegmenter(cfg.model)
    load_flax_variables(model, {"params": jstate_np.params, "batch_stats": jstate_np.batch_stats})
    state = create_train_state(cfg, model, 1, "cpu")
    adam = jstate_np.opt_state[0]
    load_optax_adam_state(model, state.optimizer, {"count": adam.count, "mu": adam.mu, "nu": adam.nu})
    state.step = int(jstate_np.step)
    # back again, bit for bit
    back = optax_adam_state(model, state.optimizer)
    assert int(back["count"]) == int(adam.count) == 1
    for key in ("mu", "nu"):
        for path, a in _leaves(getattr(adam, key)):
            np.testing.assert_array_equal(_get(back[key], path), a)
    for path, a in _leaves(jstate_np.params):
        np.testing.assert_array_equal(_get(flax_variables(model)["params"], path), a)
    # one more step in each
    jnew, jm = jstep(clone_state(jstate), {k: jnp.asarray(a) for k, a in batch.items()})
    jnew = jax.tree.map(np.asarray, jnew)
    m = make_step_fns(cfg, augment=False)[0](state, tensors(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    after = flax_variables(model)
    # the second update's direction is mu/sqrt(nu) of two gradients: no sign in doubt
    # except where both steps' gradients are noise; the rule of test_torch_train holds
    jgrads = jax.tree.map(lambda mu, mu0: (mu - 0.9 * mu0) / 0.1,
                          jnew.opt_state[0].mu, jstate_np.opt_state[0].mu)
    assert_params_after_step(jnew.params, after["params"], jgrads)
    assert_stats_close(jnew.batch_stats, after["batch_stats"], atol=1e-5)
    assert state.step == int(jnew.step) == 2


# -- trainer and command line ------------------------------------------------------


def write_dataset(folder, n_train=4, n_val=2, n_windows=3, n_points=40, seed=0):
    """kmeans_<name>.npz in the [N, 13, W] layout, labels a function of z and
    NDVI, and the split lists."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_train + n_val):
        pc = rng.uniform(0, 1, size=(n_points, 13, n_windows)).astype(np.float32)
        z, ndvi = pc[:, 2], pc[:, 9]
        pc[:, 3] = np.where(z > 0.7, 15, np.where(ndvi > 0.5, 5, 1))
        save_cloud(str(folder / f"kmeans_cloud{i}.npz"), pc)
        names.append(f"cloud{i}.pkl")
    write_split_list(str(folder / "train_seg_files.txt"), names[:n_train])
    write_split_list(str(folder / "val_seg_files.txt"), names[n_train:])
    return names


def make_trainer(data_dir, work, cfg, names, cached=True):
    def batcher(ns, seed):
        b = PaddedBatcher(WindowedCloudDataset(str(data_dir), ns), cfg.train.batch_size,
                          n_points=cfg.data.n_points, max_windows=cfg.data.max_windows, seed=seed)
        return DeviceCachedBatcher(b, "cpu") if cached else b
    model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(0))
    return Trainer(cfg, model, batcher(names[:4], 0), batcher(names[4:], 1), str(work),
                   name="t", device="cpu")


@pytest.fixture
def small_cfg():
    from ampnet_tpu_torch.core.config import DataConfig

    return AMPNetConfig(data=DataConfig(n_points=32, max_windows=3),
                        train=TrainConfig(batch_size=2, epochs=2, learning_rate=3e-3))


@pytest.mark.parametrize("cached", [True, False])
def test_trainer_fit_writes_best_checkpoint_and_resume_restores_it(tmp_path, small_cfg, cached):
    names = write_dataset(tmp_path)
    trainer = make_trainer(tmp_path, tmp_path / "work", small_cfg, names, cached=cached)
    history = trainer.fit(2)
    assert len(history["train"]) == len(history["val"]) == 2
    for m in history["train"]:
        assert np.isfinite(m["loss"]) and m["windows_per_sec"] > 0 and m["epoch_seconds"] > 0
        assert "iou_tower" in m and "miou" in m
    assert trainer.state.model.training  # the eval passes put it back
    assert trainer.state.step == 4
    assert trainer.ckpt.exists("t_best")
    meta = trainer.ckpt.load_meta("t_best")
    assert meta["config"]["train"]["batch_size"] == 2 and meta["number_of_points"] == 32
    saved = trainer.ckpt.load_payload("t_best")
    fresh = make_trainer(tmp_path, tmp_path / "work", small_cfg, names, cached=cached)
    assert fresh.resume()
    assert fresh.epoch == int(saved["epoch"]) and fresh.best_val_loss == meta["best_val_loss"]
    payloads_equal(saved, ckpt_mod.payload(fresh.state.snapshot(copy=False)))
    assert os.path.getsize(os.path.join(trainer.log_train.logdir, "scalars.csv")) > 0
    trainer.close()
    fresh.close()


def test_trainer_plateau_and_early_stop(tmp_path, small_cfg):
    import dataclasses

    names = write_dataset(tmp_path)
    cfg = small_cfg.replace(train=dataclasses.replace(small_cfg.train, plateau_patience=1,
                                                      early_stop_patience=2))
    trainer = make_trainer(tmp_path, tmp_path / "work", cfg, names)
    trainer.best_val_loss = float("-inf")  # no epoch improves
    history = trainer.fit(5)
    assert len(history["train"]) == 2 and trainer.epochs_since_improvement == 2
    assert trainer.state.lr_scale == 0.25
    assert trainer.state.learning_rate() == pytest.approx(3e-3 * 0.25)
    trainer.close()


def test_trainer_train_and_serve_default_to_the_card(tmp_path, small_cfg, monkeypatch):
    names = write_dataset(tmp_path)
    _, state = stepped_state(steps=0)
    ckpt = CheckpointManager(str(tmp_path / "ckpts")).save(
        "best", state, config_json=AMPNetConfig().to_json(), **META)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_server(build_parser().parse_args(["serve", "--model_checkpoint", ckpt]))
    b = PaddedBatcher(WindowedCloudDataset(str(tmp_path), names[:4]), 2, n_points=32, max_windows=3)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(small_cfg, AMPNetSegmenter(small_cfg.model), b, None, str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", str(tmp_path), "--path_list_files", str(tmp_path)])


@pytest.mark.parametrize("flags, item", [
    (["--arch", "gru", "--att_geom_tokens"], "item 4"),
    (["--task", "classification", "--local_agg", "edge"], "item 4"),
    (["--num_devices", "2"], "item 5"),
    (["--distill_from", "a,b"], "item 4"),
    (["--local_agg", "edge"], "item 4"),
    (["--geom_features"], "item 4"),
    (["--att_geom_tokens"], "item 4"),
    (["--dtype", "bfloat16"], "item 7"),
    (["--oversample_factor", "2"], "item 7"),
    (["--seg_weighing", "INS"], "item 7"),
    (["--grad_accum", "3"], "divisible"),
])
def test_train_refuses_options_this_slice_does_not_cover(flags, item, capsys):
    assert main(["train", "data", "--batch_size", "4", "--device", "cpu", *flags]) == 1
    assert item in capsys.readouterr().err


def test_train_command_line_then_serve_its_checkpoint(tmp_path):
    (tmp_path / "data").mkdir()
    write_dataset(tmp_path / "data")
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "ampnet_tpu_torch", "train", str(tmp_path / "data"),
           "--path_list_files", str(tmp_path / "data"), "--out_path", str(out),
           "--number_of_points", "32", "--number_of_windows", "3", "--batch_size", "2",
           "--epochs", "2", "--device", "cpu", "--ckpt_io", "sync"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout[r.stdout.index("{"): r.stdout.rindex("}") + 1])
    assert np.isfinite(summary["loss"]) and "miou" in summary
    ckpt = out / "checkpoints" / "attention_segmentation_best"
    assert (ckpt / "state.pt").exists() and (ckpt / "meta.json").exists()

    cfg, model = load_model(str(ckpt), device="cpu")
    assert cfg.data.n_points == 32 and not model.training
    server = make_server(build_parser().parse_args([
        "serve", "--model_checkpoint", str(ckpt), "--device", "cpu", "--port", "0",
        "--backend", "fused", "--max_clusters", "3"]))
    t = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["model"] == "attention_segmentation_best" and health["n_points"] == 32
        pts = np.random.default_rng(0).normal(size=(150, 9)).astype(np.float32)
        req = urllib.request.Request(f"http://{host}:{port}/v1/predict", data=pts.tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            labels = np.frombuffer(resp.read(), np.int8)
        np.testing.assert_array_equal(
            labels, server.service.inferencer.predict_many([pts], seeds=[0])[0])
    finally:
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()
