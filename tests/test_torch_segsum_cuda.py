"""The sorted segment-sum kernel (``orbslamm_tpu_torch/csrc/segsum.cu``) on the
card: bitwise equal to itself, within the reordering bound of its plain
version, and the one route of every float segment sum of ``ops/ba.py`` on a
CUDA tensor. Every test here needs an NVIDIA GPU and skips without one;
the file imports nothing of JAX (run it on the card with
``python -m pytest -m cuda tests/test_torch_segsum_cuda.py``).

Tolerance: float32 sums of the same L values in two orders differ by at most
2 (L - 1) 2^-24 sum |v| per segment (each of the L - 1 additions rounds by at
most 2^-24 of a partial sum, which is at most sum |v|, in each order).
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
          ("one_segment", 20000, 9, (9,)), ("no_edges", 0, 64, (6,))]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU/interpret mode)")
    return torch.device("cuda")


def _case(name, E, n, shape, seed, dev):
    rng = np.random.default_rng(seed)
    ids = np.full(E, n // 2) if name == "one_segment" else rng.integers(0, n, E)
    vals = rng.normal(size=(E,) + shape).astype(np.float32)
    return (ss.segment_plan(torch.as_tensor(ids, device=dev), n),
            torch.as_tensor(vals, device=dev))


def _bound(plan, vals):
    a = ss.segment_sum_ref(plan, vals.abs()).reshape(plan.n, -1)
    L = (plan.end - plan.start).to(torch.float32)[:, None]
    return 2.0 * torch.clamp_min(L - 1, 0) * 2.0 ** -24 * a


@pytest.mark.cuda
@pytest.mark.parametrize("name, E, n, shape", SHAPES)
def test_kernel_repeats_and_matches_plain(name, E, n, shape):
    """Two launches bitwise equal; the kernel within the reordering bound of
    ``index_add_`` in edge order; one launch counted per call."""
    dev = _card()
    plan, vals = _case(name, E, n, shape, E + n, dev)
    before = ss.launches
    a = ss.segment_sum(plan, vals)
    b = ss.segment_sum(plan, vals, "sorted")  # on the card both forms run the kernel
    want = ss.segment_sum_ref(plan, vals)
    torch.cuda.synchronize()
    assert ss.launches == before + 2
    assert a.shape == want.shape and torch.equal(a, b)
    d = (a - want).reshape(n, -1).abs()
    assert bool((d <= _bound(plan, vals)).all()), float(d.max())


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
    launch the kernel and call no ``index_add_``; two runs of each solve
    are bitwise equal."""
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
    before = ss.launches
    runs = [tba.pose_graph_optimize(prob, iters=3, cg_iters=10) for _ in range(2)]
    assert ss.launches > before and not adds and torch.equal(*runs)

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
