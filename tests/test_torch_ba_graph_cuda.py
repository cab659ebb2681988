"""The pose solve's CUDA graphs (``ops/ba.py`` ``pose_optimize`` on a CUDA
tensor) on the card: a replay is bitwise equal to the eager call
(``_pose_optimize``) at the tracking step's keys (B=1 and B=2, monocular and
RGB-D rows, N=2048 and another N), a later call with other inputs leaves an
earlier answer as it was, each key is captured once and then replayed, the
cache keeps the 8 keys used last, and a graph reads its inputs anew at every
call (a changed ``K``, a number ``sigma2``). Every test here needs an NVIDIA
GPU and skips without one; the file imports nothing of JAX (run it on the
card with ``python -m pytest --noconftest -m cuda tests/test_torch_ba_graph_cuda.py``).
"""

import math

import pytest
import torch

from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import geometry as tgeo
from orbslamm_tpu_torch.utils.trace import get_tracer

pytestmark = pytest.mark.cuda

BF = 40.0  # TUM2.yaml's bf


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs; no CPU/interpret mode)")
    return torch.device("cuda")


def _K(dev, f=520.9):
    return torch.tensor([[f, 0, 325.1], [0, f + 0.1, 249.7], [0, 0, 1]], device=dev)


def _problem(N, B, stereo, seed, dev, scalar_sigma=False):
    """The tracking step's layout: N padded keypoint rows, about 600 of them
    matched, outliers among them; B start poses ([4,4] for B=1)."""
    g = torch.Generator().manual_seed(seed)
    n = min(N, 600)
    X = torch.rand(n, 3, generator=g) * 6 - 3
    X[:, 2] += 8.0
    T_true = tgeo.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.01, 0.03]))
    K = _K("cpu")
    pc = tgeo.transform_points(T_true, X)
    uv = tgeo.project(K, pc) + 0.7 * torch.randn(n, 2, generator=g)
    uv[:30] += torch.rand(30, 2, generator=g) * 80 - 40
    ur = uv[:, 0] - BF / pc[:, 2] + 0.5 * torch.randn(n, generator=g)
    ur[torch.rand(n, generator=g) > 0.5] = -1.0
    level = torch.randint(0, 4, (N,), generator=g)
    pad = lambda x, v=0.0: torch.cat([x, torch.full((N - n,) + x.shape[1:], v, dtype=x.dtype)])
    valid = pad(torch.rand(n, generator=g) > 0.05, False)
    T0 = torch.stack([tgeo.se3_exp(torch.tensor([0.12, -0.02, 0.15, 0.03, 0.0, 0.02])),
                      torch.eye(4)])[:B]
    a = dict(T_init=T0 if B > 1 else T0[0], K=K, pts_w=pad(X), uv_obs=pad(uv), valid=valid,
             sigma2=1.44 if scalar_sigma else (1.2 ** level.float()) ** 2,
             ur_obs=pad(ur, -1.0) if stereo else None, bf=BF if stereo else 0.0)
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in a.items()}


def _eager(a):
    return tba._pose_optimize(a["T_init"], a["K"], a["pts_w"], a["uv_obs"], a["valid"],
                              a["sigma2"], 4, 10, tba.CHI2_MONO, a["ur_obs"], a["bf"])


def _same(x, y):
    return all(torch.equal(u, v) for u, v in zip(x, y))


def _counters():
    c = get_tracer().metrics()["counters"]
    return c.get("ba.pose_graph_captures", 0.0), c.get("ba.pose_graph_replays", 0.0)


@pytest.mark.parametrize("N", [2048, 700])
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "rgbd"])
@pytest.mark.parametrize("B", [1, 2])
def test_replay_is_bitwise_the_eager_call(B, stereo, N):
    dev = _card()
    tba._pose_graphs._graphs.clear()
    a = _problem(N, B, stereo, 11, dev)
    want = _eager(a)
    first = tba.pose_optimize(**a)  # the capture, then its first replay
    again = tba.pose_optimize(**a)
    torch.cuda.synchronize()
    assert first.T_cw.shape == want.T_cw.shape and first.inliers.dtype == torch.bool
    assert _same(first, want) and _same(again, want)
    assert int(want.n_inliers.min()) > 400  # the problem is solved, not degenerate


def test_a_later_call_leaves_an_earlier_answer():
    dev = _card()
    tba._pose_graphs._graphs.clear()
    a, b = _problem(2048, 2, True, 1, dev), _problem(2048, 2, True, 2, dev)
    out_a = tba.pose_optimize(**a)
    kept = tuple(x.clone() for x in out_a)
    out_b = tba.pose_optimize(**b)
    torch.cuda.synchronize()
    assert _same(out_a, kept) and _same(out_b, _eager(b))
    assert not torch.equal(out_a.T_cw, out_b.T_cw)
    assert out_a.T_cw.data_ptr() != out_b.T_cw.data_ptr()


def test_one_capture_per_key_then_replays():
    dev = _card()
    tba._pose_graphs._graphs.clear()
    tr = get_tracer()
    c0, r0 = _counters()
    n0 = len(tr.spans())
    keys = [_problem(2048, 2, True, 3, dev), _problem(2048, 1, True, 3, dev)]
    for _ in range(3):
        for a in keys:
            tba.pose_optimize(**a)
    c1, r1 = _counters()
    assert (c1 - c0, r1 - r0) == (2, 4) and len(tba._pose_graphs._graphs) == 2
    modes = [e.attrs.get("graph") for e in tr.spans()[n0:] if e.name == "ba.pose_optimize"]
    assert modes == ["capture", "capture"] + ["replay"] * 4


def test_the_cache_keeps_the_eight_keys_used_last():
    dev = _card()
    tba._pose_graphs._graphs.clear()
    a = _problem(256, 1, False, 4, dev)
    ths = [tba.CHI2_MONO + 0.5 * i for i in range(9)]
    outs = [tba.pose_optimize(**a, chi2_th=th) for th in ths]
    assert len(tba._pose_graphs._graphs) == 8
    assert [k[-2] for k in tba._pose_graphs._graphs] == ths[1:]  # the first went
    c0, _ = _counters()
    again = tba.pose_optimize(**a, chi2_th=ths[0])
    assert _counters()[0] == c0 + 1 and len(tba._pose_graphs._graphs) == 8
    assert _same(again, outs[0])


def test_a_changed_K_and_a_number_sigma2_are_read_at_every_call():
    dev = _card()
    tba._pose_graphs._graphs.clear()
    a = _problem(2048, 1, True, 5, dev, scalar_sigma=True)
    tba.pose_optimize(**a)
    c0, _ = _counters()
    b = dict(a, K=_K(dev, 518.0), sigma2=2.25)
    got = tba.pose_optimize(**b)
    assert _counters()[0] == c0  # the same key: replayed, not captured
    want = _eager(b)
    assert _same(got, want)
    assert not torch.equal(got.T_cw, _eager(a).T_cw)
    assert math.isfinite(float(got.T_cw.abs().sum()))
