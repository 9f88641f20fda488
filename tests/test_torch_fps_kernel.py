"""The farthest-point-sampling kernel (``csrc/fps.cu``, ``ops/sampling.py``'s
``batched_farthest_point_sampling_kernel``) and how
``batched_farthest_point_sampling`` reaches it.

On the CPU: the routing (a CUDA tensor goes to the kernel as contiguous
float32 xyz, any other runs the plain loop and counts no launch), the
wrapper's refusals, the plain loop's edge semantics that the kernel is held
to (ties to the lower index, the masked start, a cloud with no valid point,
more samples than valid points, a NaN coordinate) against a NumPy loop, and
the kernel's argmax emulated: the running minima compared as int32 bit
patterns, each thread's first maximum, then the warps' and the block's
(largest key, least index).

On a card (marked ``card``, skipped without CUDA): the kernel's indices equal
the plain loop's on the same card, as integers, at the whole-cloud cell's
three levels on 8 seeds, on exact ties, under masks, at ragged sizes and
both layouts (registers up to 16,384 points, scratch above), with a NaN,
captured in a CUDA graph (one launch counted a replay), and linked in a
profiler trace to its dispatcher op inside the caller's range. It imports no JAX;
from the repo root on the card:
``python -m pytest tests/test_torch_fps_kernel.py -q -m card --noconftest``
(``tests/conftest.py`` imports JAX).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ampnet_tpu_torch.ops import cuda_build, sampling
from ampnet_tpu_torch.ops.launch_count import add_launches, recording
from ampnet_tpu_torch.ops.sampling import (
    batched_farthest_point_sampling,
    batched_farthest_point_sampling_kernel,
    batched_farthest_point_sampling_plain,
)

REPO = Path(__file__).resolve().parents[1]


def numpy_fps(xyz: np.ndarray, s: int, mask=None) -> np.ndarray:
    """The loop in NumPy float32, written apart from the port's:
    ``np.minimum`` keeps NaN, ``np.argmax`` takes the first maximum and
    counts NaN as the maximum."""
    xyz = xyz.astype(np.float32)
    out = np.zeros((xyz.shape[0], s), np.int64)
    for c in range(xyz.shape[0]):
        valid = np.ones(xyz.shape[1], bool) if mask is None else mask[c]
        dist = np.where(valid, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32)
        last = int(np.argmax(valid))
        out[c, 0] = last
        for i in range(1, s):
            sq = (xyz[c] - xyz[c, last]) * (xyz[c] - xyz[c, last])
            dist = np.minimum(dist, (sq[:, 0] + sq[:, 1]) + sq[:, 2])
            last = int(np.argmax(dist))
            out[c, i] = last
    return out


def grid_cloud(side: int) -> np.ndarray:
    """side³ points on the integer grid: every step has exact ties."""
    g = np.arange(side, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)


def edge_case(name: str):
    """name → (xyz [B, N, 3] float32, samples, mask or None)."""
    rng = np.random.default_rng(5)
    if name == "line_ties":  # 0, 2, 2 (a copy), 1 on a line
        xyz = np.array([[[0, 0, 0], [2, 0, 0], [2, 0, 0], [1, 0, 0]]], np.float32)
        return xyz, 6, None
    if name == "duplicates":  # each point twice, in shuffled order
        pts = rng.random((1, 20, 3), dtype=np.float32)
        return np.concatenate([pts, pts], 1)[:, rng.permutation(40)], 40, None
    if name == "grid":
        return grid_cloud(4), 64, None
    if name == "masked_start":
        mask = np.ones((2, 30), bool)
        mask[0, :7] = False  # cloud 0 starts at 7
        mask[1, ::2] = False  # cloud 1 at 1
        return rng.random((2, 30, 3), dtype=np.float32), 12, mask
    if name == "all_invalid":
        mask = np.ones((2, 30), bool)
        mask[1] = False
        return rng.random((2, 30, 3), dtype=np.float32), 9, mask
    if name == "fewer_valid_than_samples":
        mask = np.zeros((1, 30), bool)
        mask[0, [3, 11, 17, 29]] = True
        return rng.random((1, 30, 3), dtype=np.float32), 10, mask
    if name == "nan_coordinate":
        xyz = rng.random((2, 30, 3), dtype=np.float32)
        xyz[0, 13, 1] = np.nan
        return xyz, 8, None
    raise KeyError(name)


EDGE_CASES = ("line_ties", "duplicates", "grid", "masked_start", "all_invalid",
              "fewer_valid_than_samples", "nan_coordinate")


def run(fn, xyz, s, mask):
    return fn(torch.from_numpy(xyz), s, None if mask is None else torch.from_numpy(mask))


# --- the CPU: routing, refusals, the loop's semantics, the argmax -------------

@pytest.mark.parametrize("batched", [True, False])
def test_a_cpu_tensor_runs_the_plain_loop_and_counts_no_launch(batched, monkeypatch):
    def kernel(*args):
        raise AssertionError("the kernel was called for a CPU tensor")

    monkeypatch.setattr(sampling, "batched_farthest_point_sampling_kernel", kernel)
    pts = torch.from_numpy(np.random.default_rng(1).random((2, 50, 9), dtype=np.float32))
    before = batched_farthest_point_sampling.launches
    if batched:
        got = batched_farthest_point_sampling(pts, 16)
        want = batched_farthest_point_sampling_plain(pts, 16)
    else:
        got = sampling.farthest_point_sampling(pts[1], 16)[None]
        want = batched_farthest_point_sampling_plain(pts[1:], 16)
    assert torch.equal(got, want)
    assert batched_farthest_point_sampling.launches == before


def test_a_card_tensor_goes_to_the_kernel_as_contiguous_float32_xyz(monkeypatch):
    calls = []

    def kernel(xyz, s, mask):  # stands in for the launch
        calls.append((xyz, s, mask))
        return batched_farthest_point_sampling_plain(xyz, s, mask)

    monkeypatch.setattr(sampling, "batched_farthest_point_sampling_kernel", kernel)
    monkeypatch.setattr(sampling, "_on_card", lambda t: True)
    pts = torch.from_numpy(np.random.default_rng(2).random((2, 50, 9)))  # float64, 9 columns
    mask = torch.ones(50, 2, dtype=torch.bool).t()  # not contiguous
    got = batched_farthest_point_sampling(pts, 16, mask)
    (xyz, s, m), = calls
    assert xyz.dtype == torch.float32 and xyz.is_contiguous() and xyz.shape == (2, 50, 3)
    assert torch.equal(xyz, pts[..., :3].float()) and s == 16
    assert m.is_contiguous() and torch.equal(m, mask)
    assert torch.equal(got, batched_farthest_point_sampling_plain(pts, 16, mask))


REFUSALS = {  # case → the error the wrapper raises before any launch
    "float64": TypeError,
    "four_columns": ValueError,
    "one_cloud_unbatched": ValueError,
    "empty_cloud": ValueError,
    "no_clouds": ValueError,
    "no_samples": ValueError,
    "non_contiguous": ValueError,
    "mask_not_bool": TypeError,
    "mask_unlike_xyz": ValueError,
    "mask_non_contiguous": ValueError,
    "on_the_cpu": ValueError,
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_kernel_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    xyz, s, mask = torch.rand(2, 40, 3), 8, None
    if case == "float64":
        xyz = xyz.double()
    elif case == "four_columns":
        xyz = torch.rand(2, 40, 4)
    elif case == "one_cloud_unbatched":
        xyz = xyz[0]
    elif case == "empty_cloud":
        xyz = torch.rand(2, 0, 3)
    elif case == "no_clouds":
        xyz = torch.rand(0, 40, 3)
    elif case == "no_samples":
        s = 0
    elif case == "non_contiguous":
        xyz = torch.rand(2, 40, 6)[..., ::2]
    elif case == "mask_not_bool":
        mask = torch.ones(2, 40, dtype=torch.uint8)
    elif case == "mask_unlike_xyz":
        mask = torch.ones(2, 41, dtype=torch.bool)
    elif case == "mask_non_contiguous":
        mask = torch.ones(40, 2, dtype=torch.bool).t()
    if case != "on_the_cpu":  # every other check comes before the device's
        monkeypatch.setattr(sampling, "_on_card", lambda t: True)
    def reached_the_launch(name, signatures):  # the refusal must come first
        raise AssertionError("reached the launch")

    monkeypatch.setattr(cuda_build, "load", reached_the_launch)
    before = batched_farthest_point_sampling.launches
    with pytest.raises(REFUSALS[case]):
        batched_farthest_point_sampling_kernel(xyz, s, mask)
    assert batched_farthest_point_sampling.launches == before


@pytest.mark.parametrize("case", EDGE_CASES)
def test_the_plain_loop_keeps_its_edge_semantics(case):
    xyz, s, mask = edge_case(case)
    got = run(batched_farthest_point_sampling_plain, xyz, s, mask).numpy()
    assert np.array_equal(got, numpy_fps(xyz, s, mask))
    if case == "line_ties":
        assert got.tolist() == [[0, 1, 3, 0, 0, 0]]
    elif case == "masked_start":
        assert got[:, 0].tolist() == [7, 1]
        assert mask[np.arange(2)[:, None], got].all()  # no masked point is ever picked
    elif case == "all_invalid":
        assert not got[1].any()  # the cloud without a valid point: index 0 throughout
        assert mask[0, got[0]].all()
    elif case == "fewer_valid_than_samples":
        assert sorted(got[0, :4]) == [3, 11, 17, 29]
        assert (got[0, 4:] == 3).all()  # every valid point at 0: the lowest repeats
    elif case == "duplicates":
        # the first 20 picks are 20 distinct places, each its copy's lower index
        first = got[0, :20]
        assert len({tuple(xyz[0, i]) for i in first}) == 20
        for i in first:
            twin = [j for j in range(40) if j != i and (xyz[0, j] == xyz[0, i]).all()]
            assert twin[0] > i
    elif case == "nan_coordinate":  # NaN is the maximum, then every distance is NaN
        assert got[0].tolist() == [0, 13] + [0] * (s - 2)


def kernel_argmax(dists: torch.Tensor) -> torch.Tensor:
    """``csrc/fps.cu``'s argmax over [B, N] running minima: int32 keys (the
    float bits; min.NaN's NaN is 0x7fffffff), thread t holding points
    k * threads + t (P = the least power of two with N <= 1024 P, at most 16;
    else 1,024 threads striding), each thread's first maximum, then each
    warp's and the block's largest key with the least index holding it."""
    b, n = dists.shape
    per = -(-n // 1024)
    p = 1 << (per - 1).bit_length() if per <= 16 else per
    threads = -(-(-(-n // p)) // 32) * 32
    keys = dists.view(torch.int32).to(torch.int64)
    keys = torch.where(dists.isnan(), 0x7FFFFFFF, keys)
    low = -(2**31)
    pad = torch.full((b, p * threads - n), low, dtype=torch.int64)
    grid = torch.cat([keys, pad], 1).reshape(b, p, threads)
    index = torch.arange(p * threads).reshape(p, threads).expand(b, p, threads)
    best, k = grid.max(dim=1)  # torch.max: the first maximum along k, ascending index
    arg = torch.gather(index, 1, k[:, None])[:, 0]

    def reduce(best, arg, width):
        best, arg = best.reshape(b, -1, width), arg.reshape(b, -1, width)
        top = best.max(dim=-1, keepdim=True).values
        return top[..., 0], torch.where(best == top, arg, 2**32).min(dim=-1).values

    best, arg = reduce(best, arg, 32)  # each warp
    best, arg = reduce(best, arg, best.shape[1])  # the block
    return arg[:, 0]


@pytest.mark.parametrize("n", [1, 31, 33, 256, 1024, 3000, 16384, 16385, 40000])
def test_the_kernels_argmax_takes_torchs_first_maximum(n):
    """Running minima from the values a step can hold (-inf, +0 and up,
    +inf, NaN), many tied: the emulated reduction picks torch.argmax's index."""
    gen = torch.Generator().manual_seed(n)
    values = torch.tensor([float("-inf"), 0.0, 1e-30, 0.25, 0.5, 3.0e38, float("inf"),
                           float("nan")])
    for weights in ([1, 1, 1, 1, 1, 1, 1, 0.02], [5, 1, 0, 0, 0, 0, 0, 0], [1] + [0] * 7,
                    [0, 0, 0, 1, 1, 0, 0, 0]):
        pick = torch.multinomial(torch.tensor(weights, dtype=torch.float), 3 * n, True,
                                 generator=gen)
        dists = values[pick].reshape(3, n)
        assert torch.equal(kernel_argmax(dists), torch.argmax(dists, dim=1))


@pytest.mark.parametrize("variant", ["scratch", "scratch_smem_xyz"])
def test_kernel_timing_variants_apply_to_the_fps_kernel_source(variant):
    """Every source variant ``kernel_timing.py --kernels fps --variants``
    times still finds the text it replaces in csrc/fps.cu, and changes it."""
    spec = importlib.util.spec_from_file_location("kernel_timing", REPO / "kernel_timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    assert set(timing.FPS_VARIANTS) == {"scratch", "scratch_smem_xyz"}
    source = (REPO / "ampnet_tpu_torch" / "csrc" / "fps.cu").read_text()
    assert timing.variant_source(variant, source, "fps") != source


# --- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on_card(card, xyz, s, mask=None):
    """(the kernel's indices, the plain loop's) on the card, on the CPU."""
    x = torch.as_tensor(xyz).to(card)
    m = None if mask is None else torch.as_tensor(mask).to(card)
    before = batched_farthest_point_sampling.launches
    with torch.inference_mode():
        got = batched_farthest_point_sampling(x, s, m)
        want = batched_farthest_point_sampling_plain(x, s, m)
    torch.cuda.synchronize()
    assert batched_farthest_point_sampling.launches == before + 1
    return got.cpu(), want.cpu()


CELL_LEVELS = {"sa1": (16384, 1024), "sa2": (1024, 256), "sa3": (256, 64)}


@pytest.mark.card
@pytest.mark.parametrize("level", list(CELL_LEVELS))
def test_kernel_picks_the_plain_loops_indices_at_the_cell_levels(level, card):
    n, s = CELL_LEVELS[level]
    for seed in range(4100000001, 4100000009):
        gen = torch.Generator(device=card).manual_seed(seed)
        xyz = torch.rand((32, n, 3), generator=gen, device=card)  # the unit cube, as the cell
        got, want = on_card(card, xyz, s)
        assert torch.equal(got, want), f"seed {seed}: {int((got != want).sum())} indices differ"


@pytest.mark.card
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_keeps_the_plain_loops_edge_semantics(case, card):
    xyz, s, mask = edge_case(case)
    got, want = on_card(card, xyz, s, mask)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), numpy_fps(xyz, s, mask))


@pytest.mark.card
@pytest.mark.parametrize("side", [16, 26])  # 4,096 and 17,576 grid points: both layouts
def test_kernel_breaks_grid_ties_as_the_plain_loop(side, card):
    xyz = grid_cloud(side)
    got, want = on_card(card, np.concatenate([xyz, xyz[:, ::-1].copy()]), 512)
    assert torch.equal(got, want)


RAGGED = {  # name → (B, N, S)
    "one_point_one_sample": (3, 1, 1),
    "one_point_five_samples": (2, 1, 5),
    "n33_all": (4, 33, 33),
    "n1000_all": (2, 1000, 1000),
    "n3000": (5, 3000, 700),
    "n16384_one_sample": (2, 16384, 1),
    "n16385_all": (1, 16385, 16385),
    "n16385": (3, 16385, 1024),
    "n50000": (2, 50000, 2048),
    "many_clouds": (300, 256, 64),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(RAGGED))
def test_kernel_picks_the_plain_loops_indices_at_ragged_sizes(case, card):
    b, n, s = RAGGED[case]
    gen = torch.Generator(device=card).manual_seed(b * 100003 + n)
    xyz = torch.rand((b, n, 3), generator=gen, device=card) * 50.0 - 25.0
    mask = torch.rand((b, n), generator=gen, device=card) < 0.7
    for m in (None, mask):
        got, want = on_card(card, xyz, s, m)
        assert torch.equal(got, want), f"mask {m is not None}"


@pytest.mark.card
def test_kernel_takes_an_offset_strided_cloud_as_the_plain_loop(card):
    """Nine columns, half precision, a view at an offset: the router's cast."""
    pts = torch.rand((5, 2, 4000, 9), device=card).half()[1:4, 1]
    got, want = on_card(card, pts, 300)
    assert torch.equal(got, want)


@pytest.mark.card
def test_kernel_launches_once_a_call_captured_and_replayed(card):
    gen = torch.Generator(device=card).manual_seed(4100000011)
    xyz = torch.rand((32, 16384, 3), generator=gen, device=card)
    mask = torch.rand((32, 16384), generator=gen, device=card) < 0.9

    def call():
        return batched_farthest_point_sampling(xyz, 1024, mask)

    with torch.inference_mode():
        want = batched_farthest_point_sampling_plain(xyz, 1024, mask)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            eager = call()
        torch.cuda.current_stream(card).wait_stream(side)
        before = batched_farthest_point_sampling.launches
        graph = torch.cuda.CUDAGraph()
        with recording() as launches, torch.cuda.graph(graph):
            out = call()
        assert launches == {batched_farthest_point_sampling: 1}
        assert batched_farthest_point_sampling.launches == before
        for i in range(2):
            out.fill_(-1)
            graph.replay()
            add_launches(launches)
            torch.cuda.synchronize()
            assert batched_farthest_point_sampling.launches == before + i + 1
            assert torch.equal(out, want)
    assert torch.equal(eager, want)


@pytest.mark.card
def test_a_profiler_links_the_kernel_to_its_op_inside_the_callers_range(card):
    """The launch is an operator of torch's dispatcher, so a trace links the
    kernel to it (a range reader files it under ``pointnet2.fps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    xyz = torch.rand((4, 4096, 3), device=card)
    batched_farthest_point_sampling(xyz, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("pointnet2.fps"):
            batched_farthest_point_sampling(xyz, 64)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    kernels = [e for e in events
               if e.device_type() == DeviceType.CUDA and "fps_kernel" in e.name()]
    assert len(kernels) == 1
    # other host records (the profiler's own) may share the op's correlation id
    (op,) = [e for e in host if e.name() == "ampnet_tpu_torch::fps_sample"]
    assert kernels[0].linked_correlation_id() == op.correlation_id() != 0
    (rng,) = [e for e in host if e.name() == "pointnet2.fps"]

    def ns(e, what):  # torch's event API gives ns or only µs, by version
        f = getattr(e, f"{what}_ns", None)
        return f() if f is not None else getattr(e, f"{what}_us")() * 1000

    assert ns(rng, "start") <= ns(op, "start") < ns(rng, "start") + ns(rng, "duration")
