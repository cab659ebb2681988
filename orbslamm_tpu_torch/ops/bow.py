"""Bag-of-binary-words place recognition (port of orbslamm_tpu/ops/bow.py).

Same design as the JAX package: the vocabulary is a flat level-major array
of node descriptors, tree descent is a fixed-depth ladder of Hamming
distances against each descriptor's k children, a BoW vector is a dense
L1-normalized tf-idf row, and the keyframe database is the stacked
[K, n_words] matrix. Files load with numpy and the same schema as the JAX
package's ``.npz`` (and DBoW2's ``ORBvoc.txt``); ``build_vocabulary``
trains a tree from descriptors on the device (hierarchical k-majority).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orbslamm_tpu_torch.ops.matching import _top_k, unpack_bits
from orbslamm_tpu_torch.utils.trace import stage


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    nodes: torch.Tensor  # [n_nodes, 32] uint8 — level-major flat tree
    branching: int
    depth: int
    idf: torch.Tensor  # [n_words] float32
    # per-node validity for trees loaded from DBoW2 files (not complete
    # k-ary trees); None = every slot populated
    node_valid: torch.Tensor | None = None

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    def to(self, device) -> Vocabulary:
        nv = None if self.node_valid is None else self.node_valid.to(device)
        return dataclasses.replace(self, nodes=self.nodes.to(device), idf=self.idf.to(device),
                                   node_valid=nv)


def _build_voc_device(desc: torch.Tensor, valid: torch.Tensor, branching: int, depth: int,
                      iters: int, draws: torch.Tensor):
    """Hierarchical k-majority over all groups of a level at once: Hamming
    distances from one [N,256] x [256,G*k] product of 0/1 float32 bits
    (pop(a) + pop(c) - 2<a,c>, exact), masked to each descriptor's own
    group, and majority-vote centroids from ``index_add_`` segment sums
    (sums of 0/1, exact in any order). ``draws`` [depth, N] are the random
    keys that pick each group's k initial members; ``valid`` masks the
    padding rows. Returns (packed nodes [n_nodes, 32] uint8, idf [k^depth])."""
    dev = desc.device
    bits = unpack_bits(desc) * valid[:, None]  # [N,256] f32 in {0,1}
    N = bits.shape[0]
    w = valid.to(torch.float32)
    group = torch.zeros(N, dtype=torch.int64, device=dev)  # slot id within the level
    pop_b = bits.sum(1)
    level_cents = []
    for level in range(depth):
        G = branching ** level
        Gk = G * branching
        # init: k random members per group (segmented top-k of random keys;
        # non-members score -1, ties taken lowest index first as lax.top_k)
        member = (group[None, :] == torch.arange(G, device=dev)[:, None]) & valid[None, :]
        _, init_idx = _top_k(torch.where(member, draws[level][None, :],
                                         torch.full_like(draws[level][None, :], -1.0)),
                             branching)  # [G,k]
        cents = bits[init_idx.reshape(-1)]  # [Gk,256]
        own = (torch.arange(Gk, device=dev) // branching)[None, :] == group[:, None]  # [N,Gk]

        def assign_to(cents):
            d = pop_b[:, None] + cents.sum(1)[None, :] - 2.0 * (bits @ cents.T)
            d = torch.where(own, d, torch.full_like(d, float("inf")))
            return torch.argmin(d, dim=1)  # first minimum, as jnp.argmin

        for _ in range(iters):
            assign = assign_to(cents)
            # 0/1 values over <= max_train (32768) < 2^24 rows: exact in any order
            sums = torch.zeros((Gk, bits.shape[1]), dtype=torch.float32, device=dev)
            sums.index_add_(0, assign, bits * w[:, None])
            cnts = torch.zeros(Gk, dtype=torch.float32, device=dev).index_add_(0, assign, w)
            new = (sums / torch.clamp_min(cnts[:, None], 1.0)) >= 0.5
            # an empty cluster keeps its previous centroid
            cents = torch.where(cnts[:, None] > 0, new.to(torch.float32), cents)
        group = assign_to(cents)
        level_cents.append(cents)

    nodes_bits = torch.cat(level_cents, 0)  # level-major
    weights = 2.0 ** torch.arange(8, dtype=torch.float32, device=dev)  # little bit order
    packed = (nodes_bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)
    counts = torch.zeros(branching ** depth, dtype=torch.float32, device=dev).index_add_(
        0, group, w) + 1.0
    idf = torch.log(valid.sum().to(torch.float32) / counts)
    return packed, idf


def build_vocabulary(descriptors, branching: int = 8, depth: int = 3, iters: int = 8,
                     seed: int = 0, max_train: int = 32768, *, device,
                     draws=None) -> Vocabulary:
    """Hierarchical binary k-majority vocabulary training on ``device``.

    descriptors: [N, 32] uint8 training set (array or tensor), strided down
    to ``max_train`` if larger and zero-padded to the next power of two (the
    padded size fixes the draws and the idf, as in the JAX package).
    The per-level random keys come from a CPU generator seeded with
    ``seed``, so a tree trained on the card equals one trained on the CPU;
    ``draws`` ([depth, padded N] float32) replaces them.
    Returns a Vocabulary with branching^depth leaf words, idf from the
    training set."""
    desc = torch.as_tensor(descriptors, device=device)
    if len(desc) > max_train:
        desc = desc[::int(np.ceil(len(desc) / max_train))][:max_train]
    n = len(desc)
    cap = max(1 << int(np.ceil(np.log2(max(n, branching)))), branching)
    pad = torch.zeros((cap - n, desc.shape[1]), dtype=torch.uint8, device=device)
    valid = torch.arange(cap, device=device) < n
    if draws is None:
        g = torch.Generator(device="cpu").manual_seed(seed)
        draws = torch.rand((depth, cap), generator=g, dtype=torch.float32)
    draws = torch.as_tensor(draws, dtype=torch.float32).to(device)
    with stage("bow.train"):
        nodes, idf = _build_voc_device(torch.cat([desc, pad], 0), valid, branching, depth,
                                       iters, draws)
    return Vocabulary(nodes=nodes, branching=branching, depth=depth, idf=idf)


def vocabulary_from_numpy(nodes, idf, branching: int, depth: int, node_valid=None, *,
                          device) -> Vocabulary:
    nv = None if node_valid is None or np.asarray(node_valid).size == 0 else (
        torch.as_tensor(np.asarray(node_valid, bool), device=device))
    return Vocabulary(nodes=torch.as_tensor(np.asarray(nodes, np.uint8), device=device),
                      branching=int(branching), depth=int(depth),
                      idf=torch.as_tensor(np.asarray(idf, np.float32), device=device),
                      node_valid=nv)


def save_vocabulary_npz(voc: Vocabulary, path) -> None:
    """Write the JAX package's ``.npz`` schema."""
    np.savez_compressed(
        path,
        nodes=voc.nodes.cpu().numpy(),
        idf=voc.idf.cpu().numpy(),
        branching=np.int32(voc.branching),
        depth=np.int32(voc.depth),
        node_valid=(voc.node_valid.cpu().numpy() if voc.node_valid is not None
                    else np.zeros(0, bool)),
    )


def load_vocabulary_npz(path, *, device) -> Vocabulary:
    z = np.load(path)
    return vocabulary_from_numpy(z["nodes"], z["idf"], int(z["branching"]), int(z["depth"]),
                                 z["node_valid"], device=device)


def load_orb_vocabulary_text(path, max_depth: int = 4, *, device) -> Vocabulary:
    """Load a DBoW2 text vocabulary (``k L scoring weighting`` header, then
    one node per line ``parent_id is_leaf d0..d31 weight``, ids implicit by
    line order from 1, root 0), truncated to ``max_depth`` levels. Leaves
    above the cut propagate down as single-child chains; the idf of a cut
    word is the largest leaf weight below it."""
    from pathlib import Path

    lines = Path(path).read_text().split("\n")
    k, L = (int(x) for x in lines[0].split()[:2])
    depth = min(L, max_depth)
    parents: list[int] = [0]
    is_leaf: list[bool] = [False]
    descs: list[np.ndarray] = [np.zeros(32, np.uint8)]
    weights: list[float] = [0.0]
    for ln in lines[1:]:
        ln = ln.strip()
        if not ln:
            continue
        parts = ln.split()
        parents.append(int(parts[0]))
        is_leaf.append(bool(int(parts[1])))
        descs.append(np.asarray([int(x) for x in parts[2:34]], np.uint8))
        weights.append(float(parts[34]))
    n_nodes = len(parents)
    children: list[list[int]] = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parents[i]].append(i)

    total = sum(k ** (lv + 1) for lv in range(depth))
    nodes = np.zeros((total, 32), np.uint8)
    valid = np.zeros((total,), bool)
    idf = np.zeros((k ** depth,), np.float32)

    def max_leaf_weight(node: int) -> float:
        if is_leaf[node] or not children[node]:
            return weights[node]
        return max(max_leaf_weight(c) for c in children[node])

    stack = [(c, 0, i) for i, c in enumerate(children[0][:k])]
    while stack:
        node, level, slot = stack.pop()
        off = _level_offset(k, level)
        nodes[off + slot] = descs[node]
        valid[off + slot] = True
        if level == depth - 1:
            idf[slot] = max_leaf_weight(node)
            continue
        kids = children[node][:k]
        if not kids or is_leaf[node]:
            stack.append((node, level + 1, slot * k))
        else:
            for j, c in enumerate(kids):
                stack.append((c, level + 1, slot * k + j))
    return vocabulary_from_numpy(nodes, idf, k, depth, valid, device=device)


def _level_offset(branching: int, level: int) -> int:
    """Start row of ``level`` in the level-major nodes array."""
    return sum(branching ** (lv + 1) for lv in range(level))


def assign_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[..., M, 32] descriptors -> [..., M] int32 word ids (-1 for invalid).
    The Hamming distance to each child is the sum of |bit differences|, as
    in the JAX package (exact small integers in float32); argmin takes the
    first child among equals, as ``jnp.argmin`` does."""
    dev = desc.device
    node = torch.zeros(desc.shape[:-1], dtype=torch.int64, device=dev)
    bits = unpack_bits(desc)  # [..., M, 256]
    kk = torch.arange(voc.branching, device=dev)
    for level in range(voc.depth):
        off = _level_offset(voc.branching, level)
        child_base = node * voc.branching
        idx = off + child_base[..., None] + kk  # [..., M, k]
        d = (bits[..., None, :] - unpack_bits(voc.nodes[idx])).abs().sum(-1)
        if voc.node_valid is not None:
            d = torch.where(voc.node_valid[idx], d, torch.full_like(d, float("inf")))
        node = child_base + torch.argmin(d, dim=-1)
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """[..., M] word ids -> L1-normalized tf-idf [..., n_words]."""
    n = voc.n_words
    safe = torch.where(words >= 0, words, torch.full_like(words, n)).long()
    tf = torch.zeros(words.shape[:-1] + (n + 1,), dtype=torch.float32, device=words.device)
    tf = tf.scatter_add(-1, safe, torch.ones_like(safe, dtype=torch.float32))[..., :n]
    v = tf * voc.idf
    return v / torch.clamp_min(v.sum(-1, keepdim=True), 1e-9)


def bow_rows(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, M, 32] descriptors + [B, M] validity -> [B, n_words] rows."""
    with stage("bow.rows"):
        return bow_vector(voc, assign_words(voc, desc, valid))


def update_bow_rows(voc: Vocabulary, kf_desc, kf_feat_valid, kf_bow, slots) -> torch.Tensor:
    """Copy of the [K, n_words] database with the rows of ``slots`` recomputed."""
    slots = torch.as_tensor(slots, device=kf_bow.device).long()
    out = kf_bow.clone()
    out[slots] = bow_rows(voc, kf_desc[slots], kf_feat_valid[slots])
    return out


def bow_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score 1 - 0.5 |v1 - v2|_1; v2 may be a [K, n_words] database
    (and v1 a [B, n_words] batch against it)."""
    if v2.ndim == 2:
        return 1.0 - 0.5 * (v1[..., None, :] - v2).abs().sum(-1)
    return 1.0 - 0.5 * (v1 - v2).abs().sum(-1)
