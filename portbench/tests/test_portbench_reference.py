"""The plain reference against the port on the CPU at small sizes (every
width the published one): the eval forward against the ``xla`` backend and
the int8 scheme against the ``int8`` backend's plain chains, a served
cloud's labels against ``TiledInferencer``, one training step against the
port's."""

import numpy as np
import pytest
import torch

from portbench import clients, inputs, program
from portbench.drivers.forward_chained import rel_rms
from portbench.reference import ampnet as ref
from portbench.reference.tiling import predict_cloud
from portbench.tests import small

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(small.SEED, CPU)


@pytest.mark.parametrize("backend,bits,tol", [("xla", 0, 1e-5), ("fused", 0, 1e-5),
                                              ("int8", 8, 1e-3)])
def test_eval_forward_equals_the_port(weights, backend, bits, tol):
    from ampnet_tpu_torch.models.backends import make_forward

    config = small.files("att_fp32.forward_b32")["config"]
    cfg, model = program.port_model(weights, config, CPU)
    x, cent = inputs.windows(7, 1, 2, 3, 64, CPU)
    pad = torch.tensor([[False, False, True], [False, False, False]])
    got = make_forward(model, cfg, backend, CPU)(x, cent, pad)
    want = ref.eval_logits(x, cent, pad, weights, quant_bits=bits)
    assert rel_rms(got, want) < tol


def test_served_labels_equal_the_port(weights):
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    config = small.files("att_fp32.serve_c4")["config"]
    cfg, model = program.port_model(weights, config, CPU)
    tiled = TiledInferencer(model, cfg, backend="fused", device="cpu")
    for i, n in enumerate((1153, 2000, 2304)):
        cloud = clients.make_cloud(small.SEED, 0, i, n)
        want = predict_cloud(cloud, weights, CPU, 64, 18)[0].argmax(axis=1)
        got = tiled.predict_many([cloud], seeds=[0])[0]
        assert np.array_equal(got, want)


def test_one_training_step_equals_the_port(weights):
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    f = small.files("att_fp32.train_b32")
    t = f["config"]["train"]
    cfg, model = program.port_model(weights, f["config"], CPU, seed=11)
    state = create_train_state(cfg, model, steps_per_epoch=4, device=CPU)
    pts, cent, labels = inputs.labelled(3, 200, 4, 3, 64, 5, CPU)
    batch = {"points": pts, "labels": labels, "centroids": cent}
    params = dict(model.named_parameters())
    loss = float(make_step_fns(cfg, augment=True)[0](state, batch)["loss"])
    grads = program.reference_layout(
        model, {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in params.items()})
    recipe = {"dropout": t["dropout"], "lr": t["learning_rate"],
              "class_weights": t["class_weights"], "reg_weight": t["reg_weight"]}
    losses, g1, _ = ref.train_steps(weights, [batch], 11, 0, recipe)
    assert loss == pytest.approx(losses[0], rel=1e-6)
    med = np.median([float(v.norm()) for v in g1.values()])
    for k, g in g1.items():
        assert abs(float(grads[k].norm()) - float(g.norm())) <= 1e-5 * max(float(g.norm()), med)


@pytest.mark.parametrize("seed", [small.SEED, 20, 21, 24])
def test_serving_weights_let_more_than_one_class_lead(seed):
    from portbench.drivers.serve_http import serving_weights

    f = small.files("att_fp32.serve_c4")
    m, traffic = f["config"]["model"], f["workload"]["traffic"]
    w = serving_weights(seed, CPU, m, traffic)
    cloud = clients.make_cloud(seed, 0, 0, traffic["points_max"])
    (logits,) = predict_cloud(cloud, w, CPU, m["n_points"], m["max_clusters"])
    shares = np.bincount(logits.argmax(axis=1), minlength=m["num_classes"]) / len(logits)
    assert shares.max() < 0.95 and (shares > 0.01).sum() >= 2, shares
