"""The sorted segment-sum kernel (``orbslamm_tpu_torch/csrc/segsum.cu``) on the
card: bitwise equal to its plain version in its own order
(``segment_sum_tiled_ref``, run on the card) and to itself, within the
reordering bound of ``index_add_``, one kernel launch a call, and the one
route of every float segment sum of ``ops/ba.py`` on a CUDA tensor. Every
test here needs an NVIDIA GPU and skips without one; the file imports
nothing of JAX (run it on the card with
``python -m pytest -m cuda tests/test_torch_segsum_cuda.py``).

Tolerance against ``index_add_``: float32 sums of the same L values in two
orders differ by at most 2 (L - 1) 2^-24 sum |v| per segment (each of the
L - 1 additions rounds by at most 2^-24 of a partial sum, which is at most
sum |v|, in each order). Against the tiled plain version: exact.
"""

import numpy as np
import pytest
import torch

from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import geometry as tgeo
from orbslamm_tpu_torch.ops.cuda import segsum as ss

# (name, E, n, row shape): the solves' shapes, cut to test size, and the edge cases
SHAPES = [("cameras", 65536, 128, (6, 6)), ("points", 65536, 8192, (3,)),
          ("weights", 65536, 8192, ()), ("pose_graph", 700, 128, (7, 7)),
          ("pose_graph_g", 700, 128, (7,)), ("pairs", 4096, 20 * 8192, (6, 3)),
          ("one_segment", 20000, 9, (9,)), ("no_edges", 0, 64, (6,)),
          ("padded", 65536, 8192, (6,)), ("long_49", 40000, 3, (7, 7))]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU/interpret mode)")
    return torch.device("cuda")


def _case(name, E, n, shape, seed, dev):
    rng = np.random.default_rng(seed)
    if name in ("one_segment", "long_49"):
        ids = np.full(E, n // 2)
    elif name == "padded":  # most edges on segment 0, as the solves' padded observations
        ids = np.where(rng.random(E) < 0.85, 0, rng.integers(0, n, E))
    else:
        ids = rng.integers(0, n, E)
    vals = rng.normal(size=(E,) + shape).astype(np.float32)
    return (ss.segment_plan(torch.as_tensor(ids, device=dev), n),
            torch.as_tensor(vals, device=dev))


def _bound(plan, vals):
    a = ss.segment_sum_ref(plan, vals.abs()).reshape(plan.n, -1)
    L = (plan.end - plan.start).to(torch.float32)[:, None]
    return 2.0 * torch.clamp_min(L - 1, 0) * 2.0 ** -24 * a


def _tiled(plan, vals):
    return ss.segment_sum_tiled_ref(plan, vals)  # in the kernel's tiles


@pytest.mark.cuda
@pytest.mark.parametrize("name, E, n, shape", SHAPES)
def test_kernel_repeats_and_matches_plain(name, E, n, shape):
    """The kernel bitwise equal to ``segment_sum_tiled_ref`` and to a second
    launch; within the reordering bound of ``index_add_`` in edge order; one
    call, one kernel launch; every counter back at 0."""
    dev = _card()
    plan, vals = _case(name, E, n, shape, E + n, dev)
    before, kernels = ss.launches, ss.kernel_launches
    a = ss.segment_sum(plan, vals)
    b = ss.segment_sum(plan, vals, "sorted")  # on the card both forms run the kernel
    want = ss.segment_sum_ref(plan, vals)
    torch.cuda.synchronize()
    assert ss.launches == before + 2 and ss.kernel_launches == kernels + 2
    assert a.shape == want.shape and a.is_contiguous() and torch.equal(a, b)
    assert torch.equal(a, _tiled(plan, vals))
    assert not bool(plan.tables.counters.any())
    d = (a - want).reshape(n, -1).abs()
    assert bool((d <= _bound(plan, vals)).all()), float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 6, 7, 9, 18, 36, 49])
def test_every_width_matches_tiled(width):
    """At every row width the solves sum, on padded point edges (one long
    segment, short ones, empty ones): the kernel bitwise equal to the tiled
    plain version, with 16-, 8- and 4-byte copies (values offset by one
    float take the 4-byte path)."""
    dev = _card()
    plan, vals = _case("padded", 30000, 4000, (width,), width, dev)
    want = _tiled(plan, vals)
    assert torch.equal(ss.segment_sum(plan, vals), want)
    buf = torch.empty(vals.numel() + 1, device=dev)
    shifted = buf[1:].view_as(vals)
    shifted.copy_(vals)
    assert shifted.data_ptr() % 8 == 4
    assert torch.equal(ss.segment_sum(plan, shifted), want)


@pytest.mark.cuda
def test_one_kernel_launch_a_call():
    """torch.profiler sees one ``segsum_kernel`` and no other device work
    per call, at a shape with segments across many tiles."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    plan, vals = _case("padded", 65536, 8192, (3,), 1, dev)
    ss.segment_sum(plan, vals)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ss.segment_sum(plan, vals)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(c for k, c in counts.items() if "segsum_kernel" in k) == 10, counts
    assert all("segsum_kernel" in k for k in counts), counts


@pytest.mark.cuda
def test_graph_replays_repeat():
    """Two replays of a captured CUDA graph of three calls, and two eager
    launches, all bitwise equal; the counters are 0 after each."""
    dev = _card()
    plan, vals = _case("padded", 65536, 8192, (6, 6), 2, dev)
    eager = [ss.segment_sum(plan, vals) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.segment_sum(plan, vals)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ss.segment_sum(plan, vals) for _ in range(3)]
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert not bool(plan.tables.counters.any())
        replays.append([o.clone() for o in outs])
    for r in replays:
        for o in r:
            assert torch.equal(o, eager[0])
    assert torch.equal(eager[0], eager[1])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [7, 49])
def test_pair_matches_its_references(width):
    """``segment_sum_pair`` on the card: one launch, bitwise the tiled pair
    reference, within the reordering bound (and the final add's rounding) of
    two ``index_add_`` and an add."""
    dev = _card()
    rng = np.random.default_rng(width)
    E, C = 1400, 128
    ei, ej = (torch.as_tensor(rng.integers(0, C, E), device=dev) for _ in range(2))
    shape = (7,) if width == 7 else (7, 7)
    a, b = (torch.as_tensor(rng.normal(size=(E,) + shape).astype(np.float32), device=dev)
            for _ in range(2))
    plan = ss.segment_plan_pair(ei, ej, C)
    before = ss.kernel_launches
    got = ss.segment_sum_pair(plan, a, b)
    assert ss.kernel_launches == before + 1
    assert torch.equal(got, ss.segment_sum_pair_tiled_ref(plan, a, b))
    want = ss.segment_sum_pair_ref(plan, a, b)
    d = (got - want).reshape(C, -1).abs()
    bound = _bound(plan, torch.cat([a, b])) + 2.0 ** -24 * want.reshape(C, -1).abs()
    assert bool((d <= bound).all()), float(d.max())


@pytest.mark.cuda
def test_bad_inputs_raise():
    """A non-contiguous, float64 or over-wide input raises before launch."""
    dev = _card()
    plan, vals = _case("points", 4096, 512, (6,), 0, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum(plan, vals.t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        ss.segment_sum(plan, vals.double())
    wide = torch.zeros((4096, ss.MAX_WIDTH + 1), device=dev)
    with pytest.raises(ValueError, match="floats an edge"):
        ss.segment_sum(plan, wide)


@pytest.mark.cuda
def test_all_invalid_edges_sum_to_zero():
    """Every edge on one landmark with a zero value (the solves' zero
    weights on invalid edges): every segment sums to exactly 0."""
    dev = _card()
    plan = ss.segment_plan(torch.zeros(5000, dtype=torch.int32, device=dev), 300)
    out = ss.segment_sum(plan, torch.zeros((5000, 3, 3), device=dev))
    assert bool((out == 0).all())


@pytest.mark.cuda
def test_solves_sum_through_the_kernel_only(monkeypatch):
    """``_seg_add``, the pose graph and ``bundle_adjust_cg`` on CUDA tensors
    launch the kernel and call no ``index_add_``; the pose graph makes one
    call, one launch, a product; two runs of each solve are bitwise
    equal."""
    dev = _card()
    adds = []
    real = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, "index_add_",
                        lambda self, *a, **k: adds.append(self.device) or real(self, *a, **k))
    plan, vals = _case("points", 4096, 512, (3,), 0, dev)
    before = ss.launches
    tba._seg_add(plan, vals)
    assert ss.launches == before + 1 and not adds

    rng = np.random.default_rng(0)
    C = 24
    S = torch.zeros(C, 8)
    S[:, 3] = S[:, 7] = 1.0
    S[:, 4:7] = torch.as_tensor(rng.normal(size=(C, 3)).astype(np.float32))
    ei = torch.arange(C, dtype=torch.int32)
    ej = (ei + 1) % C
    M = tgeo.sim3_compose(S[ei.long()], tgeo.sim3_inv(S[ej.long()]))
    S0 = S.clone()
    S0[:, 4:7] += torch.as_tensor(rng.normal(scale=0.05, size=(C, 3)).astype(np.float32))
    fixed = torch.zeros(C, dtype=torch.bool)
    fixed[0] = True
    prob = tba.PoseGraphProblem(S_iw=S0, node_valid=torch.ones(C, dtype=torch.bool),
                                node_fixed=fixed, edge_i=ei, edge_j=ej, edge_Sij=M,
                                edge_valid=torch.ones(C, dtype=torch.bool),
                                edge_weight=torch.ones(C))
    prob = tba.PoseGraphProblem(*(x.to(dev) for x in prob))
    before, kernels = ss.launches, ss.kernel_launches
    runs = [tba.pose_graph_optimize(prob, iters=3, cg_iters=10) for _ in range(2)]
    # one paired call a product: g, Hd and 10 CG products an LM iteration
    assert ss.launches - before == ss.kernel_launches - kernels == 2 * 3 * (2 + 10)
    assert not adds and torch.equal(*runs)

    E, P = 3000, 400
    K = torch.tensor([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]]).expand(C, 3, 3)
    T = torch.eye(4).repeat(C, 1, 1)
    T[:, 0, 3] = -0.1 * torch.arange(C)
    pts = torch.as_tensor(np.stack([rng.uniform(-1, 3, P), rng.uniform(-1, 1, P),
                                    rng.uniform(3, 6, P)], -1).astype(np.float32))
    oc = torch.as_tensor(rng.integers(0, C, E).astype(np.int32))
    op = torch.as_tensor(rng.integers(0, P, E).astype(np.int32))
    pc = pts[op.long()] + T[oc.long(), :3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 260.0 + torch.tensor([160.0, 120.0])
    p = tba.BAProblem(T_cw=T, K=K.contiguous(), cam_valid=torch.ones(C, dtype=torch.bool),
                      cam_fixed=fixed, points=pts + 0.02,
                      point_valid=torch.ones(P, dtype=torch.bool), obs_cam=oc, obs_point=op,
                      obs_uv=uv, obs_sigma2=torch.ones(E),
                      obs_valid=torch.ones(E, dtype=torch.bool))
    p = tba.BAProblem(*(None if x is None else x.to(dev) for x in p))
    before = ss.launches
    runs = [tba.bundle_adjust_cg(p, iters=3, cg_iters=10, segsum=form)
            for form in ("scatter", "sorted")]
    assert ss.launches > before and not adds
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
