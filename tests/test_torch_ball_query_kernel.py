"""The ball-query kernel (``csrc/ball_query.cu``, ``ops/sampling.py``'s
``ball_query_members_kernel``) and how ``ball_query_members`` and
PointNet++'s ``ball_query`` reach it.

On the CPU: the routing (a CUDA tensor goes to the kernel as contiguous
float32 d2, any other runs the plain body and counts no launch), the
wrapper's refusals, the plain body's edge semantics that the kernel is held
to (fewer members than ``nsample``, none, an entry at the float32 threshold
and one ulp either side, NaN, ``nsample`` above N) against a NumPy loop, and
the kernel's scan emulated: chunks of 128 entries, 4 a lane, each member's
slot from the ballots of the lanes below, the exit at the ``nsample``-th
member, the padding; ``kernel_timing.py``'s count of the entries the scan
reads, and ``chip_smoke.py``'s ctypes table of every ``csrc/`` source
against its C definitions.

On a card (marked ``card``, skipped without CUDA): the kernel's indices equal
the plain body's on the same card, as integers, at the whole-cloud cell's
three levels on 8 seeds, on the edge cases, at ragged N and on rows that
start off a 16-byte boundary, at ``nsample`` 1, 32 and 64, captured in a
CUDA graph (one launch counted a replay), and linked in a profiler trace to
its dispatcher op inside the caller's ``pointnet2.ball_query`` range. It
imports no JAX; from the repo root on the card:
``python -m pytest tests/test_torch_ball_query_kernel.py -q -m card --noconftest``
(``tests/conftest.py`` imports JAX).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ampnet_tpu_torch.models import pointnet2
from ampnet_tpu_torch.ops import cuda_build, sampling
from ampnet_tpu_torch.ops.launch_count import add_launches, recording
from ampnet_tpu_torch.ops.sampling import (
    ball_query_members,
    ball_query_members_kernel,
    ball_query_members_plain,
    batched_farthest_point_sampling,
)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "ampnet_tpu_torch" / "csrc" / "ball_query.cu"


def numpy_ball_query(d2: np.ndarray, radius: float, nsample: int) -> np.ndarray:
    """The ball query in NumPy, written apart from the port's: a float32
    comparison with radius² rounded to float32 (NaN is never a member), the
    first ``nsample`` members in ascending order, padded with the first, N
    throughout where a row has none."""
    thr = np.float32(radius * radius)
    b, s, n = d2.shape
    k = min(nsample, n)
    out = np.empty((b, s, k), np.int64)
    for i in range(b):
        for j in range(s):
            members = [m for m in range(n) if d2[i, j, m] <= thr][:k]
            out[i, j] = members + [members[0]] * (k - len(members)) if members else [n] * k
    return out


def ulp(x: np.float32, direction: float) -> np.float32:
    return np.nextafter(np.float32(x), np.float32(direction))


def edge_case(name: str):
    """name → (d2 [B, S, N] float32, radius, nsample)."""
    rng = np.random.default_rng(11)
    if name == "fewer_members_than_nsample":
        d2 = np.full((1, 2, 40), 9.0, np.float32)
        d2[0, 0, [5, 17, 30]] = 0.001
        d2[0, 1, [0, 39]] = 0.0
        return d2, 0.1, 8
    if name == "no_member":
        d2 = np.full((2, 3, 50), 1.0, np.float32)
        d2[1, 1, 7] = 0.0  # one row of the second cloud has one
        return d2, 0.1, 4
    if name in ("at_threshold_rounded_down", "at_threshold_rounded_up"):
        # float32(0.1²) lies below the double 0.1², float32(0.3²) above 0.3²
        radius = 0.1 if name.endswith("down") else 0.3
        thr = np.float32(radius * radius)
        d2 = np.full((1, 3, 12), 5.0, np.float32)
        d2[0, :, 2] = thr
        d2[0, :, 6] = ulp(thr, np.inf)
        d2[0, :, 9] = ulp(thr, -np.inf)
        d2[0, 1, 0] = ulp(thr, np.inf)
        d2[0, 2, 11] = thr
        return d2, radius, 32
    if name == "nan_entry":
        d2 = rng.random((1, 2, 64), dtype=np.float32) * 0.02
        d2[0, 0, [0, 3, 40]] = np.nan
        d2[0, 1, :] = np.nan
        d2[0, 1, 33] = 0.0
        return d2, 0.1, 16
    if name == "nsample_above_n":
        d2 = rng.random((2, 3, 10), dtype=np.float32) * 0.02
        return d2, 0.1, 32
    if name == "more_members_than_nsample":
        d2 = rng.random((2, 5, 300), dtype=np.float32) * 0.012
        return d2, 0.1, 32
    if name == "negative_and_infinite":  # _sqdist can round a distance below 0
        d2 = np.array([[[np.inf, -1e-7, 0.5, -np.inf, 0.0, np.inf]]], np.float32)
        return d2, 0.5, 4
    raise KeyError(name)


EDGE_CASES = ("fewer_members_than_nsample", "no_member", "at_threshold_rounded_down",
              "at_threshold_rounded_up", "nan_entry", "nsample_above_n",
              "more_members_than_nsample", "negative_and_infinite")


# --- the CPU: routing, refusals, the plain body's semantics, the scan ---------

def test_a_cpu_tensor_runs_the_plain_body_and_counts_no_launch(monkeypatch):
    def kernel(*args):
        raise AssertionError("the kernel was called for a CPU tensor")

    monkeypatch.setattr(sampling, "ball_query_members_kernel", kernel)
    xyz = torch.from_numpy(np.random.default_rng(1).random((2, 300, 3), dtype=np.float32))
    centers = xyz[:, :20]
    before = ball_query_members.launches
    got = pointnet2.ball_query(centers, xyz, 0.2, 16)
    want = ball_query_members_plain(pointnet2._sqdist(centers, xyz), 0.2, 16)
    assert torch.equal(got, want) and got.dtype == torch.int64 and got.shape == (2, 20, 16)
    assert torch.equal(ball_query_members(pointnet2._sqdist(centers, xyz), 0.2, 16), want)
    assert ball_query_members.launches == before


def test_a_card_tensor_goes_to_the_kernel_as_contiguous_float32_d2(monkeypatch):
    calls = []

    def kernel(d2, radius, nsample):  # stands in for the launch
        calls.append((d2, radius, nsample))
        return ball_query_members_plain(d2, radius, nsample)

    monkeypatch.setattr(sampling, "ball_query_members_kernel", kernel)
    monkeypatch.setattr(sampling, "_on_card", lambda t: True)
    xyz = torch.from_numpy(np.random.default_rng(2).random((2, 300, 3), dtype=np.float32))
    centers = xyz[:, :20]
    got = pointnet2.ball_query(centers, xyz, 0.2, 16)  # the model's d2
    (d2, radius, nsample), = calls
    assert d2.dtype == torch.float32 and d2.is_contiguous() and d2.shape == (2, 20, 300)
    assert torch.equal(d2, pointnet2._sqdist(centers, xyz)) and (radius, nsample) == (0.2, 16)
    assert torch.equal(got, ball_query_members_plain(d2, 0.2, 16))
    strided = torch.rand(2, 300, 20).transpose(1, 2)  # a view: made contiguous on the way
    ball_query_members(strided, 0.3, 8)
    d2 = calls[-1][0]
    assert d2.is_contiguous() and torch.equal(d2, strided)


REFUSALS = {  # case → the error the wrapper raises before any launch
    "float64": TypeError,
    "float16": TypeError,
    "rank_2": ValueError,
    "rank_4": ValueError,
    "no_rows": ValueError,
    "no_points": ValueError,
    "nsample_0": ValueError,
    "nsample_negative": ValueError,
    "non_contiguous": ValueError,
    "on_the_cpu": ValueError,
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_kernel_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    d2, nsample = torch.rand(2, 16, 40), 8
    if case == "float64":
        d2 = d2.double()
    elif case == "float16":
        d2 = d2.half()
    elif case == "rank_2":
        d2 = d2[0]
    elif case == "rank_4":
        d2 = d2[None]
    elif case == "no_rows":
        d2 = torch.rand(2, 0, 40)
    elif case == "no_points":
        d2 = torch.rand(2, 16, 0)
    elif case == "nsample_0":
        nsample = 0
    elif case == "nsample_negative":
        nsample = -3
    elif case == "non_contiguous":
        d2 = torch.rand(2, 40, 16).transpose(1, 2)
    if case != "on_the_cpu":  # every other check comes before the device's
        monkeypatch.setattr(sampling, "_on_card", lambda t: True)

    def reached_the_launch(name, signatures):  # the refusal must come first
        raise AssertionError("reached the launch")

    monkeypatch.setattr(cuda_build, "load", reached_the_launch)
    before = ball_query_members.launches
    with pytest.raises(REFUSALS[case], match="ball_query_members_kernel"):
        ball_query_members_kernel(d2, 0.1, nsample)
    assert ball_query_members.launches == before


@pytest.mark.parametrize("case", EDGE_CASES)
def test_the_plain_body_keeps_its_edge_semantics(case):
    d2, radius, nsample = edge_case(case)
    got = ball_query_members_plain(torch.from_numpy(d2), radius, nsample).numpy()
    assert np.array_equal(got, numpy_ball_query(d2, radius, nsample))
    if case == "fewer_members_than_nsample":
        assert got[0].tolist() == [[5, 17, 30, 5, 5, 5, 5, 5], [0, 39, 0, 0, 0, 0, 0, 0]]
    elif case == "no_member":
        assert (got[0] == 50).all() and (got[1, [0, 2]] == 50).all()
        assert got[1, 1].tolist() == [7] * 4
    elif case.startswith("at_threshold"):
        # the threshold itself and the ulp below are in, the ulp above out
        assert got[0, 0, :2].tolist() == [2, 9] and got.shape[-1] == 12
        assert got[0, 1, :2].tolist() == [2, 9] and got[0, 2, :3].tolist() == [2, 9, 11]
        if case.endswith("up"):  # float32(0.09) > 0.09: a double comparison would leave it out
            assert float(np.float32(0.09)) > 0.3 * 0.3
    elif case == "nan_entry":
        assert not {0, 3, 40} & set(got[0, 0].tolist())
        assert got[0, 1].tolist() == [33] * 16
    elif case == "nsample_above_n":
        assert got.shape == (2, 3, 10)
    elif case == "negative_and_infinite":
        assert got[0, 0].tolist() == [1, 3, 4, 1]


@pytest.mark.parametrize("radius", [0.05, 0.1, 0.2])
def test_ball_query_equals_a_numpy_loop_on_the_models_distances(radius):
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.random((2, 500, 3), dtype=np.float32))
    centers = pointnet2.gather_points(xyz, batched_farthest_point_sampling(xyz, 40))
    got = pointnet2.ball_query(centers, xyz, radius, 32)
    want = numpy_ball_query(pointnet2._sqdist(centers, xyz).numpy(), radius, 32)
    assert np.array_equal(got.numpy(), want)


def kernel_constants() -> dict:
    """``kChunk`` and ``kChunks`` as ``csrc/ball_query.cu`` declares them."""
    text = SOURCE.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("kChunk", "kChunks")}


def kernel_scan(d2: np.ndarray, thr: np.float32, k: int) -> np.ndarray:
    """``csrc/ball_query.cu``'s scan of each row of ``d2 [rows, n]``: groups
    of kChunks chunks of kChunk entries, lane l testing entries 4l .. 4l + 3
    of a chunk (NaN past the row's end); a member's slot is the count so far,
    plus the members of the lanes below, plus those before it in its lane;
    the scan stops at the k-th member; the first member pads the rest, n
    where there is none. Slots never written stay -1."""
    c = kernel_constants()
    chunk, chunks = c["kChunk"], c["kChunks"]
    assert chunk == 4 * 32
    rows, n = d2.shape
    out = np.full((rows, k), -1, np.int64)
    lanes = np.arange(32)
    for r in range(rows):
        count, first, base = 0, n, 0
        while base < n and count < k:
            for ci in range(chunks):
                if count >= k:
                    break
                at = base + ci * chunk
                entry = at + 4 * lanes[:, None] + np.arange(4)[None, :]  # [lane, j]
                vals = np.where(entry < n, d2[r, np.minimum(entry, n - 1)], np.float32(np.nan))
                ballots = [int(sum(1 << int(l) for l in lanes[vals[:, j] <= thr]))
                           for j in range(4)]
                anyb = ballots[0] | ballots[1] | ballots[2] | ballots[3]
                if anyb == 0:
                    continue
                for lane in range(32):
                    below = (1 << lane) - 1
                    slot = count + sum(bin(b & below).count("1") for b in ballots)
                    for j in range(4):
                        if ballots[j] >> lane & 1:
                            if slot < k:
                                out[r, slot] = at + 4 * lane + j
                            slot += 1
                if count == 0:
                    low = (anyb & -anyb).bit_length() - 1
                    first = at + 4 * low + next(j for j in range(4) if ballots[j] >> low & 1)
                count += sum(bin(b).count("1") for b in ballots)
            base += chunk * chunks
        out[r, min(count, k):] = first
    return out


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 511, 513, 2000])
@pytest.mark.parametrize("nsample", [1, 32, 64])
def test_the_kernels_scan_picks_the_plain_bodys_integers(n, nsample):
    """Rows of every density (none, a few, most in the ball), NaN and ties
    at the threshold: the emulated scan writes every slot, and the plain
    body's integers."""
    rng = np.random.default_rng(n * 7 + nsample)
    rows = []
    for p in (0.0, 0.002, 0.03, 0.3, 0.9, 1.0):
        rows.append(np.where(rng.random(n) < p, np.float32(0.001), np.float32(1.0)))
    row = rng.random(n, dtype=np.float32) * 0.02
    row[rng.random(n) < 0.1] = np.nan
    row[rng.random(n) < 0.1] = np.float32(0.01)  # at float32(0.1²) itself
    rows.append(row)
    d2 = np.stack(rows).astype(np.float32)
    k = min(nsample, n)
    got = kernel_scan(d2, np.float32(0.1 * 0.1), k)
    want = ball_query_members_plain(torch.from_numpy(d2)[None], 0.1, nsample)[0].numpy()
    assert (got >= 0).all()
    assert np.array_equal(got, want)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k", [1, 32])
def test_kernel_timings_bound_counts_each_row_up_to_its_kth_member(k):
    """``kernel_timing.py``'s bound prices the entries a scan stopping at
    each row's k-th member reads, the whole row where it has fewer."""
    rng, radius = np.random.default_rng(5), 0.1
    density = np.array([0.0, 0.01, 0.1, 1.0], np.float32)[:, None]  # none to every entry
    d2 = np.where(rng.random((2, 4, 300)) < density, np.float32(0.001), np.float32(1.0))
    d2 = d2.astype(np.float32)
    thr = np.float32(radius * radius)
    want = 0
    for row in d2.reshape(-1, d2.shape[-1]):
        members = np.flatnonzero(row <= thr)
        want += members[k - 1] + 1 if len(members) >= k else len(row)
    timing = load_script("kernel_timing")
    assert timing.scanned_entries(torch.from_numpy(d2), radius, k) == want
    bound = timing.ball_query_bound(torch.from_numpy(d2), radius, k)
    assert bound["scanned_share"] == want / d2.size
    assert bound["bound_ms"] == pytest.approx((4 * want + 8 * 8 * k) / 3.35e12 * 1e3)


@pytest.mark.parametrize("source", sorted(p.stem for p in SOURCE.parent.iterdir()
                                          if p.suffix in (".cu", ".cc")))
def test_the_smoke_declares_each_source_as_its_c_interface_reads(source):
    """``chip_smoke.py`` builds every source of ``csrc/`` with the table its
    module declares (``SOURCES``: ``fps`` and ``ball_query`` each have
    theirs in ``ops/sampling.py``); each function of the table is defined in
    the source with as many parameters as its ``argtypes``."""
    smoke = load_script("chip_smoke")
    text = next(p for p in SOURCE.parent.iterdir() if p.stem == source).read_text()
    table = smoke.signature_table(source)
    assert table
    for name, (_, argtypes) in table.items():
        found = re.search(rf"\b{name}\(([^)]*)\)\s*\{{", text)
        assert found, name
        params = found.group(1).strip()
        assert len(argtypes) == (0 if params in ("", "void") else params.count(",") + 1), name


# --- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on_card(card, d2, radius, nsample):
    """(the kernel's indices, the plain body's) on the card, on the CPU."""
    x = torch.as_tensor(d2).to(card)
    before = ball_query_members.launches
    with torch.inference_mode():
        got = ball_query_members(x, radius, nsample)
        want = ball_query_members_plain(x, radius, nsample)
    torch.cuda.synchronize()
    assert ball_query_members.launches == before + 1
    return got.cpu(), want.cpu()


CELL_LEVELS = {"sa1": (16384, 1024, 0.1), "sa2": (1024, 256, 0.2), "sa3": (256, 64, 0.4)}


@pytest.mark.card
@pytest.mark.parametrize("level", list(CELL_LEVELS))
def test_kernel_picks_the_plain_bodys_indices_at_the_cell_levels(level, card):
    """The model's own distances: xyz in the unit cube as the cell draws it,
    centres from farthest-point sampling, d2 from ``_sqdist``."""
    n, s, radius = CELL_LEVELS[level]
    for seed in range(4200000001, 4200000009):
        gen = torch.Generator(device=card).manual_seed(seed)
        xyz = torch.rand((32, n, 3), generator=gen, device=card)
        with torch.inference_mode():
            centers = pointnet2.gather_points(xyz, batched_farthest_point_sampling(xyz, s))
            d2 = pointnet2._sqdist(centers, xyz)
        got, want = on_card(card, d2, radius, 32)
        assert torch.equal(got, want), f"seed {seed}: {int((got != want).sum())} indices differ"
        del d2


@pytest.mark.card
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_keeps_the_plain_bodys_edge_semantics(case, card):
    d2, radius, nsample = edge_case(case)
    got, want = on_card(card, d2, radius, nsample)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), numpy_ball_query(d2, radius, nsample))


RAGGED_N = (1, 31, 33, 127, 129, 16385)


@pytest.mark.card
@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("nsample", [1, 32, 64])
def test_kernel_picks_the_plain_bodys_indices_at_ragged_sizes(n, nsample, card):
    """Odd N puts most rows off a 16-byte boundary; densities from none to
    every entry in the ball; NaN entries."""
    gen = torch.Generator(device=card).manual_seed(n * 1009 + nsample)
    for p in (0.0, 0.005, 0.05, 0.5, 1.0):
        d2 = torch.where(torch.rand((3, 37, n), generator=gen, device=card) < p,
                         torch.rand((3, 37, n), generator=gen, device=card) * 0.01, 1.0)
        d2[0, 0, : n // 2] = float("nan")
        got, want = on_card(card, d2, 0.1, nsample)
        assert torch.equal(got, want), f"p {p}"


@pytest.mark.card
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_takes_rows_that_start_off_a_16_byte_boundary(offset, card):
    """A contiguous view at an offset into its storage: no row of the
    [2, 50, 1024] block starts on a 16-byte boundary."""
    gen = torch.Generator(device=card).manual_seed(4200000100 + offset)
    flat = torch.rand(2 * 50 * 1024 + offset, generator=gen, device=card) * 0.08
    d2 = flat[offset:].view(2, 50, 1024)
    assert d2.is_contiguous() and d2.data_ptr() % 16
    for nsample in (1, 32, 64):
        got, want = on_card(card, d2, 0.2, nsample)
        assert torch.equal(got, want), f"nsample {nsample}"


@pytest.mark.card
def test_kernel_launches_once_a_call_captured_and_replayed(card):
    gen = torch.Generator(device=card).manual_seed(4200000011)
    xyz = torch.rand((32, 16384, 3), generator=gen, device=card)

    def call():
        return pointnet2.ball_query(xyz[:, :1024], xyz, 0.1, 32)

    with torch.inference_mode():
        want = ball_query_members_plain(pointnet2._sqdist(xyz[:, :1024], xyz), 0.1, 32)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            eager = call()
        torch.cuda.current_stream(card).wait_stream(side)
        before = ball_query_members.launches
        graph = torch.cuda.CUDAGraph()
        with recording() as launches, torch.cuda.graph(graph):
            out = call()
        assert launches == {ball_query_members: 1}
        assert ball_query_members.launches == before
        for i in range(2):
            out.fill_(-1)
            graph.replay()
            add_launches(launches)
            torch.cuda.synchronize()
            assert ball_query_members.launches == before + i + 1
            assert torch.equal(out, want)
    assert torch.equal(eager, want)


@pytest.mark.card
def test_a_profiler_links_the_kernel_to_its_op_inside_the_callers_range(card):
    """The launch is an operator of torch's dispatcher, so a trace links the
    kernel to it, and a range reader files it under ``pointnet2.ball_query``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    xyz = torch.rand((4, 4096, 3), device=card)
    pointnet2.ball_query(xyz[:, :256], xyz, 0.1, 32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("pointnet2.ball_query"):
            pointnet2.ball_query(xyz[:, :256], xyz, 0.1, 32)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    kernels = [e for e in events
               if e.device_type() == DeviceType.CUDA and "ball_query_kernel" in e.name()]
    assert len(kernels) == 1
    # other host records (the profiler's own) may share the op's correlation id
    (op,) = [e for e in host if e.name() == "ampnet_tpu_torch::ball_query_members"]
    assert kernels[0].linked_correlation_id() == op.correlation_id() != 0
    (rng,) = [e for e in host if e.name() == "pointnet2.ball_query"]

    def ns(e, what):  # torch's event API gives ns or only µs, by version
        f = getattr(e, f"{what}_ns", None)
        return f() if f is not None else getattr(e, f"{what}_us")() * 1000

    assert ns(rng, "start") <= ns(op, "start") < ns(rng, "start") + ns(rng, "duration")
