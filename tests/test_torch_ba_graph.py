"""The pose solve's CUDA-graph cache (``ops/ba.py`` ``pose_optimize``) seen
from the CPU: a CPU call runs the eager solve and never captures, and the
signature a graph is kept under tells apart every input a graph is
specialised to (B, N, the stereo rows, dtypes, a number ``sigma2``, and the
scalar arguments) while it ignores the values a replay reads anew. The
card's side (capture, replay, eviction) is ``test_torch_ba_graph_cuda.py``.
"""

import pytest
import torch

from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import geometry as tgeo
from orbslamm_tpu_torch.utils.trace import get_tracer

torch.set_num_threads(2)


def _args(N=64, B=2, stereo=True, seed=0, **over):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(N, 3, generator=g) * 4 - 2
    X[:, 2] += 6.0
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    T0 = torch.stack([tgeo.se3_exp(0.02 * torch.randn(6, generator=g)) for _ in range(B)])
    uv = tgeo.project(K, X) + 0.5 * torch.randn(N, 2, generator=g)
    a = dict(T_init=T0 if B > 1 else T0[0], K=K, pts_w=X, uv_obs=uv,
             valid=torch.rand(N, generator=g) > 0.1, sigma2=torch.ones(N), rounds=4,
             iters=10, chi2_th=tba.CHI2_MONO,
             ur_obs=uv[:, 0] - 40.0 / X[:, 2] if stereo else None, bf=40.0 if stereo else 0.0)
    a.update(over)
    return a


def _sig(a):
    return tba._pose_signature(**a)


def test_a_cpu_solve_is_the_eager_solve_and_never_captures():
    tr = get_tracer()
    counters = dict(tr.metrics()["counters"])
    n0 = len(tr.spans())
    a = _args()
    got = tba.pose_optimize(**a)
    want = tba._pose_optimize(*a.values())
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    solves = [e for e in tr.spans()[n0:] if e.name == "ba.pose_optimize"]
    assert [e.attrs["graph"] for e in solves] == ["eager"]
    assert len(tba._pose_graphs._graphs) == 0 and tr.metrics()["counters"] == counters


@pytest.mark.parametrize("change", [
    dict(B=1), dict(N=65), dict(stereo=False), dict(sigma2=1.44), dict(chi2_th=7.0),
    dict(bf=41.0), dict(iters=9), dict(rounds=3), dict(valid=torch.ones(64, dtype=torch.int32)),
    dict(sigma2=torch.ones(64, dtype=torch.float64)),
], ids=["B", "N", "rows", "scalar_sigma2", "chi2_th", "bf", "iters", "rounds", "valid_dtype",
        "sigma2_dtype"])
def test_the_signature_tells_apart(change):
    shape = {k: change[k] for k in ("B", "N", "stereo") if k in change}
    over = {k: v for k, v in change.items() if k not in shape}
    assert _sig(_args(**shape, **over)) != _sig(_args())


def test_a_batch_of_one_is_not_a_single_pose():
    one = _args(B=1)
    assert _sig(dict(one, T_init=one["T_init"][None])) != _sig(one)


def test_new_values_in_the_same_shapes_share_the_signature():
    a, b = _args(seed=0), _args(seed=1, sigma2=torch.full((64,), 2.0))
    assert not torch.equal(a["pts_w"], b["pts_w"]) and _sig(a) == _sig(b)
    assert _sig(_args(sigma2=1.0)) == _sig(_args(sigma2=2.25))  # a number is read anew
