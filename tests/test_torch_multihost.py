"""Processes that really cross a boundary: the port's multi-process check
(2 gloo ranks held to a 1-process golden, as ``tests/test_multihost.py``
holds the JAX one), ``train --num_devices 2 --device cpu`` end to end (rank 0
alone writes; its checkpoint loads and serves), and ``serve --num_devices 2
--device cpu``."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from ampnet_tpu_torch.cli.main import build_parser, main, make_server
from ampnet_tpu_torch.core.checkpoint import load_model
from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = ["-m", "ampnet_tpu_torch.parallel.multihost_check"]


def _spawn(extra, out):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, *WORKER, *extra, "--out", out, "--device", "cpu",
         "--epochs", "1", "--n_samples", "16", "--n_points", "32"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_two_process_training_matches_single_process(tmp_path):
    outs = [str(tmp_path / f"p{i}.json") for i in range(2)]
    golden_out = str(tmp_path / "golden.json")
    store = f"file://{tmp_path / 'store'}"
    workers = [_spawn(["--num_processes", "2", "--process_id", str(i), "--init_method", store],
                      outs[i]) for i in range(2)]
    golden = _spawn([], golden_out)
    try:
        for p in workers + [golden]:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    finally:
        for p in workers + [golden]:  # a hung rendezvous must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    res = [json.load(open(o)) for o in outs]
    gold = json.load(open(golden_out))
    assert [r["process_id"] for r in res] == [0, 1]
    assert all(r["num_processes"] == 2 for r in res) and gold["num_processes"] == 1
    # both processes read the same reduced loss, bit for bit
    assert res[0]["losses"] == res[1]["losses"]
    assert len(gold["losses"]) == len(res[0]["losses"]) == 2
    # step 1 (same batch, same weights) to reduction-order noise; step 2 on
    # post-Adam weights, which amplify it (tests/test_multihost.py)
    np.testing.assert_allclose(gold["losses"][0], res[0]["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(gold["losses"], res[0]["losses"], rtol=3e-3)


def write_dataset(folder, n_train=4, n_val=2, n_windows=3, n_points=40, seed=0):
    """kmeans_<name>.npz in the [N, 13, W] layout, labels a function of z and
    NDVI, and the split lists."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_train + n_val):
        pc = rng.uniform(0, 1, size=(n_points, 13, n_windows)).astype(np.float32)
        pc[:, 3] = np.where(pc[:, 2] > 0.7, 15, np.where(pc[:, 9] > 0.5, 5, 1))
        save_cloud(str(folder / f"kmeans_cloud{i}.npz"), pc)
        names.append(f"cloud{i}.pkl")
    write_split_list(str(folder / "train_seg_files.txt"), names[:n_train])
    write_split_list(str(folder / "val_seg_files.txt"), names[n_train:])
    return names


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --num_devices 2 --device cpu``: (exit code, out dir, what the
    ranks printed)."""
    data = tmp_path_factory.mktemp("data")
    out = tmp_path_factory.mktemp("out")
    write_dataset(data)
    printed = data / "stdout.txt"  # the ranks print to the stdout they inherit
    sys.stdout.flush()
    saved, fd = os.dup(1), os.open(printed, os.O_WRONLY | os.O_CREAT)
    os.dup2(fd, 1)
    try:
        rc = main(["train", str(data), "--path_list_files", str(data), "--out_path", str(out),
                   "--number_of_points", "32", "--number_of_windows", "3", "--batch_size", "2",
                   "--epochs", "2", "--device", "cpu", "--num_devices", "2"])
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(fd)
        os.close(saved)
    return rc, out, printed.read_text()


def test_train_two_ranks_on_the_cpu(trained):
    rc, out, printed = trained
    assert rc == 0
    assert printed.count("checkpoints + logs in") == 1  # rank 0 alone prints
    assert "miou" in printed
    assert sorted(os.listdir(out / "checkpoints")) == ["attention_segmentation_best"]
    for split in ("train", "val"):
        rows = (out / "logs" / f"attention_segmentation_{split}" / "scalars.csv").read_text()
        # one writer: each epoch's loss once, not once per rank
        assert [r.split(",")[1] for r in rows.splitlines() if r.split(",")[2] == "loss"] == \
            ["0", "1"]


def test_two_rank_checkpoint_loads_and_serves_on_two_devices(trained):
    _, out, _ = trained
    ckpt = str(out / "checkpoints" / "attention_segmentation_best")
    cfg, model = load_model(ckpt, "cpu")
    assert cfg.data.n_points == 32
    server = make_server(build_parser().parse_args([
        "serve", "--model_checkpoint", ckpt, "--device", "cpu", "--num_devices", "2",
        "--port", "0", "--backend", "fused", "--max_clusters", "3"]))
    inferencer = server.service.inferencer
    assert [d.type for d in inferencer.devices] == ["cpu", "cpu"]
    t = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.address
        rng = np.random.default_rng(0)
        clouds = [rng.normal(size=(120, 9)).astype(np.float32) for _ in range(2)]
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/predict",
            data=json.dumps({"clouds": [c.tolist() for c in clouds]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            labels = json.loads(r.read())["labels"]
        # one micro-batch, one cloud a device; the server seeds every cloud 0
        for got, want in zip(labels, inferencer.predict_many(clouds, seeds=[0, 0])):
            np.testing.assert_array_equal(np.asarray(got), want)
    finally:
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()
