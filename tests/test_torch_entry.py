"""The port's entry points (orbslamm_tpu_torch/entry.py) against the JAX
package's ``__graft_entry__.py``, on the CPU.

  * the per-frame step: the port's ``make_frame_fn``, started from the
    JAX ``entry()`` bootstrap's map and last frame (read from its ``fn``'s
    closure, carried over by ``convert``), against JAX's ``fn`` on frames
    21-24 of the same sequence with the example pose: ``T_cw`` within 1e-3
    and ``n_inliers`` within 2 (tests/test_torch_slice.py's tolerances; the
    port extracts its own features, level 0 bit-exact, others >= 98 %);
  * ``entry(device="cpu")`` bootstraps and returns finite values;
  * ``dryrun_multichip(2, devices=["cpu"] * 2)`` runs its five parts, and
    its part 2 equals the JAX package's ``make_distributed_ba`` over two
    of its virtual CPU devices on the same problem within
    tests/test_torch_dist_ba.py's bounds: poses 1e-3, points 5e-3, inlier
    mask exact, cost 1e-4 relative; the problem's pixels carry no noise,
    so both solves end at float32's floor (about 6e-8) and the cost is
    held within 1e-6 absolute there;
  * with no CUDA device, ``entry()`` and ``dryrun_multichip`` with their
    default devices raise before any work: there is no CPU fallback.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from orbslamm_tpu.ops import ba as jba
from orbslamm_tpu.parallel import dist_ba as jdist
from orbslamm_tpu_torch import convert, entry
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.ops import orb as torb

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FRAMES = (21, 22, 23, 24)


@pytest.fixture(scope="module")
def jax_entry():
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    state = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return jax.jit(fn), args, state


def test_frame_fn_matches_jax_from_its_state(jax_entry):
    jfn, jargs, st = jax_entry
    cfg = entry._small_cfg()
    m = convert.map_state_from_numpy(jax.tree.map(np.asarray, st["m"])._asdict(), device="cpu")
    last_feats = convert.features_from_numpy(jax.tree.map(np.asarray, st["last_feats"])._asdict(),
                                             device="cpu")
    fn = entry.make_frame_fn(cfg, m, torch.as_tensor(np.array(st["K"])), last_feats,
                             torch.as_tensor(np.array(st["last_lm"])),
                             torb.make_extractor(cfg.orb, cfg.camera, device="cpu"))
    seq = make_sequence(n_frames=60, n_points=900, cam=cfg.camera, seed=7, motion="forward")
    assert np.array_equal(np.asarray(jargs[0]), seq.images[FRAMES[0]])
    T_pred = np.asarray(jargs[1])
    for k in FRAMES:
        jT, jn = jfn(jnp.asarray(seq.images[k]), jnp.asarray(T_pred))
        tT, tn = fn(torch.as_tensor(seq.images[k]), torch.as_tensor(T_pred))
        assert int(jn) >= cfg.tracking.min_inliers_local_map
        assert abs(int(tn) - int(jn)) <= 2, (k, int(tn), int(jn))
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-3)


def test_entry_runs_on_the_cpu():
    fn, (image, T_pred) = entry.entry(device="cpu")
    assert image.device.type == "cpu" and T_pred.dtype == torch.float32
    T_cw, n_inliers = fn(image, T_pred)
    assert T_cw.shape == (4, 4) and bool(torch.isfinite(T_cw).all())
    assert int(n_inliers) >= entry._small_cfg().tracking.min_inliers_local_map


def test_dryrun_on_a_cpu_mesh_matches_jax_distributed_ba(capsys):
    out = entry.dryrun_multichip(2, devices=["cpu"] * 2)
    assert len(out["features"]) == 2 and out["imported"] == 0
    assert [len(r) for r in out["records"]] == [4, 4]
    assert out["gba"]["t_1_ms"] > 0 and out["gba"]["t_n_ms"] > 0
    text = capsys.readouterr().out
    assert "kf_sharded_gba: t_1dev=" in text and "overhead_efficiency=" in text
    # part 2 against the JAX package on the same problem over two devices
    _, prob_np = entry.dryrun_inputs(2)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("d",))
    jprob = jdist.shard_ba_problem(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob_np.items()}), mesh)
    want = jdist.make_distributed_ba(mesh, iters=3)(jprob)
    got = out["ba"]
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=5e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4, atol=1e-6)
    assert np.array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))


def test_entry_without_a_card_raises_and_runs_nothing(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")

    def no_session(*a, **k):
        raise AssertionError("a session was built")

    monkeypatch.setattr(entry, "MonocularSession", no_session)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2, devices=["cuda"] * 2)
