"""tools/make_vocab_torch.py, the port of tools/make_vocab.py, against the
JAX package on the CPU, on a pool of 2 worlds at 320x240 (the tool's pool
is 8 worlds at 640x480; the motions, frames and features are the tool's).

  * the pool's descriptors: on every pool frame the port's extractor and
    the JAX package's give the same levels and validity, level-0
    descriptors bit-exact and >= 98 % of the descriptors on each other
    level equal (tests/test_torch_orb.py's bounds: the level images come
    from a float resize whose rounding flips FAST ties);
  * the tool's run (``main``) on that pool with the JAX package's per-level
    training keys injected: the written file loads in both packages, and
    its tree equals the one the JAX package trains on the same descriptors
    (nodes exact, idf within 1e-6; tests/test_torch_multimap.py's training
    bounds);
  * without an output argument the tool writes
    ``build/vocab_<branching>x<depth>.npz``, never under orbslamm_tpu/data.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.ops import bow as jbow
from orbslamm_tpu.ops import orb as jorb
from orbslamm_tpu.utils import config as jc
from orbslamm_tpu_torch.ops import bow as tbow
from orbslamm_tpu_torch.ops import orb as torb
from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import make_vocab_torch as tool  # noqa: E402

WORLDS, BRANCHING, DEPTH = 2, 4, 3


def _cam(c):
    return c.CameraConfig(width=320, height=240, fx=260.45, fy=260.5, cx=162.55, cy=124.85)


def _jax_training_draws(seed, depth, n):
    """The uniform keys JAX's ``_build_voc_device`` draws per level."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(depth):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (n,))))
    return np.stack(out)


def test_pool_descriptors_match_jax():
    cam = _cam(tc)
    orb = tool.pool_orb()
    jext = jorb.make_extractor(jc.OrbConfig(n_features=orb.n_features,
                                            max_keypoints=orb.max_keypoints), _cam(jc))
    text = torb.make_extractor(orb, cam, device="cpu")
    n_frames = 0
    for image in tool.pool_images(cam, WORLDS):
        fj = jax.tree.map(np.asarray, jext(jnp.asarray(image)))
        ft = text(image)
        assert np.array_equal(ft.level.numpy(), fj.level)
        assert np.array_equal(ft.valid.numpy(), fj.valid)
        l0 = (fj.level == 0) & fj.valid
        assert l0.sum() > 0 and np.array_equal(ft.desc.numpy()[l0], fj.desc[l0])
        for level in range(1, orb.n_levels):
            sel = (fj.level == level) & fj.valid
            if sel.any():
                same = (ft.desc.numpy()[sel] == fj.desc[sel]).all(-1)
                assert same.mean() >= 0.98, (n_frames, level, same.mean())
        n_frames += 1
    assert n_frames == WORLDS * len(tool.MOTIONS) * (tool.SEQ_FRAMES // tool.FRAME_STRIDE)


def test_tool_writes_jax_tree_with_jax_draws(tmp_path, monkeypatch):
    monkeypatch.setattr(tool, "pool_camera", lambda: _cam(tc))
    monkeypatch.setattr(tool, "N_WORLDS", WORLDS)
    pools = []
    build = tbow.build_vocabulary

    def with_jax_draws(descs, branching, depth, iters, seed, max_train, device):
        pools.append(np.asarray(descs))
        n = len(descs) if len(descs) <= max_train else len(range(0, len(descs), int(
            np.ceil(len(descs) / max_train)))[:max_train])
        cap = max(1 << int(np.ceil(np.log2(max(n, branching)))), branching)
        return build(descs, branching=branching, depth=depth, iters=iters, seed=seed,
                     max_train=max_train, device=device,
                     draws=_jax_training_draws(seed, depth, cap))

    monkeypatch.setattr(tbow, "build_vocabulary", with_jax_draws)
    out = tmp_path / "voc.npz"
    assert tool.main([str(BRANCHING), str(DEPTH), str(out), "--device", "cpu"]) == 0
    (alld,) = pools
    assert alld.dtype == np.uint8 and alld.shape[1] == 32 and len(alld) > 1000
    want = jbow.build_vocabulary(alld, branching=BRANCHING, depth=DEPTH, iters=8, seed=3,
                                 max_train=32768)
    loaded_j = jbow.load_vocabulary_npz(out)
    loaded_t = tbow.load_vocabulary_npz(out, device="cpu")
    for voc in (loaded_j, loaded_t):
        assert (voc.branching, voc.depth) == (BRANCHING, DEPTH)
        assert np.array_equal(np.asarray(voc.nodes), np.asarray(want.nodes))
        np.testing.assert_allclose(np.asarray(voc.idf), np.asarray(want.idf), rtol=1e-6,
                                   atol=1e-6)


def test_default_output_is_under_build(tmp_path, monkeypatch):
    assert tool.default_out(10, 4) == REPO / "build" / "vocab_10x4.npz"
    monkeypatch.setattr(tool, "_REPO", tmp_path)
    monkeypatch.setattr(tool, "descriptor_pool",
                        lambda cam, orb, device: np.random.default_rng(0).integers(
                            0, 256, (300, 32), dtype=np.uint8))
    assert tool.main(["2", "2", "--device", "cpu"]) == 0
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    assert written == ["build/vocab_2x2.npz"]
    assert tbow.load_vocabulary_npz(tmp_path / written[0], device="cpu").n_words == 4


def test_tool_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tool.main(["2", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
