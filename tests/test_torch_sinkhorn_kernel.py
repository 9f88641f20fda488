"""The Sinkhorn kernels (``csrc/sinkhorn.cu``, ``ops/kmeans.py``'s
``sinkhorn_iterations``) and how ``sinkhorn_plan`` reaches them.

On the CPU: the routing (the kernels take a CUDA float32 logK with no point
mask, k <= 32 and at least one iteration; every other input runs the plain
loop), the wrapper's refusals, the kernels' arithmetic emulated with torch's
sums against the plain loop (bit for bit), and the tiling's sensitivity that
asks for it: float64 tiles as float32 at a small shape, yet at the served
size any other order of the sums moves a near-tie point on a few clouds in a
hundred.

On a card (marked ``card``, skipped without CUDA): ``balanced_kmeans``
through the kernels equals the plain loop on the same card bit for bit
(assignment, centroids, plan) at the served bucket, the preprocessing shapes
and the kernels' widest k, and on served clouds, and the launches count
thrice an iteration in a captured call and in each replay. It imports no JAX;
from the repo root on the card:
``python -m pytest tests/test_torch_sinkhorn_kernel.py -q -m card --noconftest``
(``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from ampnet_tpu_torch.ops import kmeans
from ampnet_tpu_torch.ops.kmeans import (
    balanced_kmeans,
    round_balanced,
    sinkhorn_iterations,
    sinkhorn_plan,
)
from ampnet_tpu_torch.ops.launch_count import add_launches, recording


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes are small: one intra-op thread runs them fastest, and the
    suite's parallel workers do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_clouds(seed: int, b: int, n: int, f: int = 3) -> torch.Tensor:
    """[b, n, f] float32: x and y uniform on [-1, 1], the rest normal x 0.5, as
    the served clouds' (x, y, NDVI)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(b, n, f)).astype(np.float32) * 0.5
    c[..., :2] = rng.uniform(-1.0, 1.0, size=(b, n, 2))
    return torch.from_numpy(c)


def make_init(seed: int, b: int, n: int, k: int) -> torch.Tensor:
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(np.stack([rng.permutation(n)[:k] for _ in range(b)]))


def emulated_iterations(logK, log_c, iters):
    """The kernels' arithmetic with torch's column sum between them: columns
    M = max_n(logK + u) (0 where infinite), E = exp((logK + u) - M); S =
    E.sum(-2); rows v = log c - (log S + M), m = max_c(logK + v) (0 where
    infinite), e = exp((logK + v) - m), s = the sum of e (on the card in the
    order of torch's sum over a short last dimension), u = -(log s + m)."""
    u = torch.zeros(logK.shape[:-1], dtype=logK.dtype)
    for _ in range(iters):
        x = logK + u[..., :, None]
        big = x.amax(dim=-2)
        big = torch.where(big.isinf(), 0.0, big)
        v = log_c - (torch.log(torch.exp(x - big[..., None, :]).sum(dim=-2)) + big)
        y = logK + v[..., None, :]
        m = y.amax(dim=-1)
        m = torch.where(m.isinf(), 0.0, m)
        u = -(torch.log(torch.exp(y - m[..., None]).sum(dim=-1)) + m)
    return u, v


def plain_only(monkeypatch):
    """From here on every input runs the plain loop."""
    monkeypatch.setattr(kmeans, "_kernels_take", lambda *args: False)


# --- the CPU: routing, refusals, the arithmetic, the sensitivity -------------

ROUTES = {  # case → (changes, whether the kernels take it)
    "kernel_case": ({}, True),
    "cpu": ({}, False),
    "point_mask": ({"point_mask": True}, False),
    "argmin": ({"lloyd_mode": "argmin"}, True),  # its one balanced update
    "wide_features": ({"f": 9}, True),  # the kernels see logK only
    "many_clusters": ({"k": 33}, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_balanced_kmeans_takes_the_kernel_only_where_it_takes_the_input(case, monkeypatch):
    change, takes = ROUTES[case]
    k, cap, f = change.get("k", 4), 16, change.get("f", 3)
    feats = make_clouds(3, 1, k * cap, f)[0]
    kw = {"capacities": (cap,) * k, "init_idx": make_init(3, 1, k * cap, k)[0],
          "lloyd_mode": change.get("lloyd_mode", "sinkhorn")}
    if change.get("point_mask"):
        kw["point_mask"] = torch.ones(k * cap, dtype=torch.bool)
    calls = []

    def kernels(logK, log_c, iters):  # stands in for the launches
        calls.append((logK, log_c, iters))
        return emulated_iterations(logK, log_c, iters)

    monkeypatch.setattr(kmeans, "sinkhorn_iterations", kernels)
    if case != "cpu":  # as if the tensor lay on a card
        monkeypatch.setattr(kmeans, "_on_card", lambda t: True)
    assign, cent = balanced_kmeans(feats, k, **kw)
    lloyd = 1 if kw["lloyd_mode"] == "argmin" else 10
    assert len(calls) == (lloyd if takes else 0)
    assert torch.equal(torch.bincount(assign.long(), minlength=k), torch.full((k,), cap))
    if takes:  # the kernels get each Lloyd iteration's contiguous logK [N, k]
        logK, log_c, iters = calls[0]
        assert logK.is_contiguous() and logK.shape == (k * cap, k) and iters == 30
        assert torch.equal(log_c, torch.log(torch.full((k,), float(cap))))
        plain_only(monkeypatch)
        want, want_cent = balanced_kmeans(feats, k, **kw)
        assert torch.equal(assign, want) and torch.equal(cent, want_cent)


REFUSALS = {  # case → the error the wrapper raises before any launch
    "float64": TypeError,
    "non_contiguous": ValueError,
    "many_clusters": ValueError,
    "capacities_unlike_k": ValueError,
    "no_iterations": ValueError,
    "on_the_cpu": ValueError,
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_sinkhorn_iterations_raise_on_what_the_kernels_do_not_take(case, monkeypatch):
    k, n = 4, 64
    logK, log_c, iters = -torch.rand(2, n, k) * 10, torch.log(torch.full((k,), n / k)), 30
    if case == "float64":
        logK = logK.double()
    elif case == "non_contiguous":
        logK = (-torch.rand(2, n, 2 * k))[..., ::2]
    elif case == "many_clusters":
        logK, log_c = -torch.rand(2, n, 33), torch.zeros(33)
    elif case == "capacities_unlike_k":
        log_c = log_c[:-1]
    elif case == "no_iterations":
        iters = 0
    if case != "on_the_cpu":  # every other check comes before the device's
        monkeypatch.setattr(kmeans, "_on_card", lambda t: True)
    before = sinkhorn_iterations.launches
    with pytest.raises(REFUSALS[case]):
        sinkhorn_iterations(logK, log_c, iters)
    assert sinkhorn_iterations.launches == before


@pytest.mark.parametrize("k,cap,b", [(9, 256, 1), (18, 128, 2), (2, 512, 1)])
def test_emulated_kernel_arithmetic_tiles_as_the_plain_loop(k, cap, b, monkeypatch):
    """The kernels' arithmetic with torch's sums between them (on the card
    the row sum takes torch's order in the kernel) gives the plain loop's
    plan bit for bit, so the same tiling and centroids."""
    n = k * cap
    feats, init = make_clouds(7 + k, b, n), make_init(7 + k, b, n, k)
    cost = kmeans._sqdist(feats, torch.stack([feats[i, init[i]] for i in range(b)]))
    caps = torch.full((k,), float(cap))
    tau = cost.mean(dim=(-2, -1), keepdim=True) * 0.05
    want = sinkhorn_plan(cost, caps, tau)
    want_assign, want_cent = balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)
    monkeypatch.setattr(kmeans, "_on_card", lambda t: True)
    monkeypatch.setattr(kmeans, "sinkhorn_iterations", emulated_iterations)
    assert torch.equal(sinkhorn_plan(cost, caps, tau), want)
    assign, cent = balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)
    assert torch.equal(assign, want_assign) and torch.equal(cent, want_cent)


def test_sinkhorn_plan_in_float64_runs_the_plain_loop(monkeypatch):
    monkeypatch.setattr(kmeans, "_on_card", lambda t: True)
    monkeypatch.setattr(kmeans, "sinkhorn_iterations", None)  # a call would fail
    cost = torch.rand(2, 64, 4, dtype=torch.float64)
    plan = sinkhorn_plan(cost, torch.full((4,), 16.0, dtype=torch.float64), 0.1)
    assert plan.dtype == torch.float64
    assert torch.allclose(plan.sum(dim=-1), torch.ones(2, 64, dtype=torch.float64))


def lloyd(feats, init, cap, iters=10):
    """``balanced_kmeans``' Sinkhorn Lloyd loop in ``feats``' dtype → its
    exact rounding (``balanced_kmeans`` itself computes in float32)."""
    k = init.shape[-1]
    cent, caps = feats[init], torch.full((k,), float(cap), dtype=feats.dtype)
    for i in range(iters):
        cost = kmeans._sqdist(feats, cent)
        tau = cost.mean().clamp_min(1e-12) * kmeans._anneal(i, iters)
        plan = sinkhorn_plan(cost, caps, tau)
        cent = kmeans._cluster_sums(plan / plan.sum(dim=-2, keepdim=True), feats)
    return round_balanced(plan, (cap,) * k)


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_tiles_as_float32(seed):
    """At this shape rounding at float32's level moves no point. (At the
    served size it does: any other order of the plain loop's sums, the mean's
    alone in float64 included, moves a near-tie point on a few served clouds
    in a hundred, and relative noise of 1e-4 on every logsumexp moved 27
    points and failed the serving cell's label check 56-fold. So the kernels
    leave the sums to torch and round everything else as the plain loop.)"""
    k, cap = 9, 256
    feats, init = make_clouds(100 + seed, 1, k * cap)[0], make_init(100 + seed, 1, k * cap, k)[0]
    a32 = balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)[0]
    assert torch.equal(lloyd(feats, init, cap), a32)
    assert torch.equal(lloyd(feats.double(), init, cap), a32)


# --- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_SHAPES = {  # name → (k, cap, batch (None: one unbatched [N, F] cloud))
    "k18_cap4096_b1": (18, 4096, 1),
    "k18_cap4096_b2": (18, 4096, 2),
    "k18_cap4096_b4": (18, 4096, 4),
    "k9_cap2048_b1": (9, 2048, 1),
    "k2_cap2048_b1": (2, 2048, 1),
    "k9_cap2048_unbatched": (9, 2048, None),
    "k5_cap1024_b3": (5, 1024, 3),  # odd k and batch
    "k32_cap512_b2": (32, 512, 2),  # the widest k
}


def both_paths(monkeypatch, call):
    """``call()`` through the kernels, then through the plain loop."""
    with torch.inference_mode():
        got = call()
        with monkeypatch.context() as m:
            plain_only(m)
            want = call()
    torch.cuda.synchronize()
    return got, want


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_tiles_as_the_plain_loop_on_the_card(shape, card, monkeypatch):
    k, cap, b = CARD_SHAPES[shape]
    n = k * cap
    for seed in (3050000011 + k, 2950000003 + k):
        feats = make_clouds(seed, b or 1, n).to(card)
        init = make_init(seed, b or 1, n, k).to(card)
        if b is None:
            feats, init = feats[0], init[0]
        before = sinkhorn_iterations.launches
        (assign, cent), (want, want_cent) = both_paths(
            monkeypatch, lambda: balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init))
        assert sinkhorn_iterations.launches == before + 3 * 30 * 10
        moved = int((assign != want).sum())
        assert moved == 0, f"{moved} points in another window than the plain loop's"
        assert torch.equal(cent, want_cent)
        cost = kmeans._sqdist(feats, cent)
        caps = torch.full((k,), float(cap), device=card)
        plan, want_plan = both_paths(monkeypatch, lambda: sinkhorn_plan(cost, caps, 0.05))
        assert torch.equal(plan, want_plan)


@pytest.mark.card
def test_kernel_tiles_served_clouds_as_the_plain_loop(card, monkeypatch):
    """Clouds as the serving cell draws them (36,865-73,728 points padded by
    copies to 18 x 4,096), each tiled alone: the same windows bit for bit."""
    k, cap = 18, 4096
    rng = np.random.default_rng(3000000019)
    for n in rng.integers(36865, 73729, size=12):
        cloud = make_clouds(int(rng.integers(1 << 31)), 1, int(n))[0].numpy()
        padded = np.concatenate([cloud, cloud[rng.integers(0, n, k * cap - n)]])
        feats = torch.from_numpy(padded).to(card)
        init = torch.from_numpy(rng.permutation(k * cap)[:k]).to(card)
        (assign, cent), (want, want_cent) = both_paths(
            monkeypatch, lambda: balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init))
        assert torch.equal(assign, want) and torch.equal(cent, want_cent)


@pytest.mark.card
def test_kernel_launches_count_thrice_an_iteration_captured_and_replayed(card):
    k, cap = 18, 4096
    feats = make_clouds(11, 1, k * cap).to(card)
    init = make_init(11, 1, k * cap, k).to(card)
    per_call = 3 * 30 * 10  # three kernels an iteration, 30 iterations, 10 Lloyd iterations

    def call():
        return balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)[0]

    with torch.inference_mode():
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            eager = call()
        torch.cuda.current_stream(card).wait_stream(side)
        before = sinkhorn_iterations.launches
        graph = torch.cuda.CUDAGraph()
        with recording() as launches, torch.cuda.graph(graph):
            out = call()
        assert launches == {sinkhorn_iterations: per_call}
        assert sinkhorn_iterations.launches == before
        for i in range(3):
            graph.replay()
            add_launches(launches)
            assert sinkhorn_iterations.launches == before + (i + 1) * per_call
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
