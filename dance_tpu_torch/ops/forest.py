"""Random forest of random-threshold trees grown in lockstep (counterpart:
dance_tpu/ops/forest.py).

All trees grow at once, the tree a batch dimension, one depth level a step:
each node scores K random (feature, threshold) candidates, the threshold
the midpoint of two random examples' values at the feature, by
``sum_c cl²/nl + cr²/nr`` (the weighted Gini gain) and keeps the best
(``_grow_level``, :43-78). Trees are complete to ``max_depth`` (node v's
children are 2v and 2v + 1), with Poisson(1) bootstrap weights,
``class_weight="balanced"`` and leaf class distributions smoothed toward
the class prior (:123-128); ``predict_proba`` is their mean over trees.

Where this differs from the JAX package:

- The per-node class histograms are segment sums. JAX's ``segment_sum``
  becomes a sort-based one (:func:`segment_sum`): a stable sort of the
  segment ids, a float64 prefix sum, differences at the segment ends.
  ``index_add_`` on the card adds floats with atomics in any order, so two
  fits could differ where two candidates score alike; this one is the same
  bit for bit on every run. With integer weights (no class weights) the
  sums are exact and the chosen splits are JAX's; with balanced weights
  they are float32 sums in another order.
- The draws (Poisson weights, candidate features, the two examples of each
  threshold) come from a CPU ``torch.Generator`` seeded with
  ``random_state`` (:func:`forest_draws`), not ``jax.random``; parity tests
  pass JAX's draws to ``fit``.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from dance_tpu_torch.utils import resolve_device


class Forest(NamedTuple):
    """Split tables and leaf distributions: ``feats``/``thrs`` (n_trees,
    max_depth, 2**(max_depth-1)), level l using the first 2**l slots;
    ``leaf_probs`` (n_trees, 2**max_depth, n_classes)."""
    feats: torch.Tensor
    thrs: torch.Tensor
    leaf_probs: torch.Tensor


class ForestDraws(NamedTuple):
    """Every random draw of a fit: ``poisson`` (n_trees, n) bootstrap
    weights or None; ``cand_f``, ``r1``, ``r2`` (n_trees, max_depth, width,
    K) int64: each node's candidate features and the two examples whose
    values' midpoint is the threshold."""
    poisson: Optional[torch.Tensor]
    cand_f: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor


def forest_draws(seed: int, n_trees: int, n: int, n_feats: int, max_depth: int,
                 n_candidates: int, bootstrap: bool = True) -> ForestDraws:
    """The draws of a fit from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    poisson = (torch.poisson(torch.ones((n_trees, n)), generator=gen) if bootstrap else None)
    shape = (n_trees, max_depth, 2 ** (max_depth - 1), n_candidates)
    cand_f = torch.randint(0, n_feats, shape, generator=gen)
    r1 = torch.randint(0, n, shape, generator=gen)
    r2 = torch.randint(0, n, shape, generator=gen)
    return ForestDraws(poisson, cand_f, r1, r2)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-row segment sums: ``out[r, s] = sum of values[r, i]`` over the
    ``i`` with ``seg[r, i] == s``. ``values`` is (R, n) or (R, n, K), ``seg``
    (R, n) int64; the sums are float64 differences of a prefix sum in
    segment order, deterministic on every device."""
    order = torch.sort(seg, dim=1, stable=True).indices
    seg_sorted = torch.gather(seg, 1, order)
    idx = order if values.dim() == 2 else order[..., None].expand_as(values)
    prefix = torch.cumsum(torch.gather(values, 1, idx).double(), dim=1)
    prefix = torch.cat([torch.zeros_like(prefix[:, :1]), prefix], dim=1)
    bounds = torch.arange(num_segments + 1, device=seg.device).expand(seg.shape[0], -1)
    starts = torch.searchsorted(seg_sorted, bounds.contiguous())  # each segment's first slot
    if values.dim() == 3:
        starts = starts[..., None].expand(-1, -1, values.shape[2])
    edge = torch.gather(prefix, 1, starts)
    return (edge[:, 1:] - edge[:, :-1]).to(values.dtype)


def _grow_level(x, y, w, node, cand_f, cand_t, n_nodes: int, n_classes: int):
    """One lockstep level of every tree (counterpart: forest.py:43). ``node``
    (T, n) each example's node, < ``n_nodes``; ``cand_f``/``cand_t`` (T,
    n_nodes, K). Returns (chosen features, chosen thresholds, new nodes)."""
    T, n = node.shape
    k = cand_f.shape[2]
    f_e = torch.gather(cand_f, 1, node[..., None].expand(-1, -1, k))  # (T, n, K)
    t_e = torch.gather(cand_t, 1, node[..., None].expand(-1, -1, k))
    rows = torch.arange(n, device=x.device)[None, :, None]
    left = (x[rows, f_e] <= t_e).to(x.dtype)
    seg = node * n_classes + y[None]
    n_seg = n_nodes * n_classes
    cl = segment_sum(w[..., None] * left, seg, n_seg).reshape(T, n_nodes, n_classes, k)
    tot = segment_sum(w, seg, n_seg).reshape(T, n_nodes, n_classes)
    cr = tot[..., None] - cl
    nl, nr = cl.sum(2), cr.sum(2)
    score = ((cl ** 2).sum(2) / torch.clamp(nl, min=1e-9)
             + (cr ** 2).sum(2) / torch.clamp(nr, min=1e-9))
    score = torch.where((nl > 0) & (nr > 0), score, -torch.inf)
    best = score.argmax(2, keepdim=True)  # the first maximum, as jnp.argmax
    chosen_f = torch.gather(cand_f, 2, best)[..., 0]
    chosen_t = torch.gather(cand_t, 2, best)[..., 0]
    go_left = x[torch.arange(n, device=x.device)[None], torch.gather(chosen_f, 1, node)] \
        <= torch.gather(chosen_t, 1, node)
    return chosen_f, chosen_t, node * 2 + (~go_left).to(node.dtype)


def _fit_forest(x: torch.Tensor, y: torch.Tensor, base_w: torch.Tensor, draws: ForestDraws,
                max_depth: int, n_classes: int) -> Forest:
    """Grow every tree to ``max_depth`` (counterpart: forest.py:81)."""
    dev = x.device
    n = x.shape[0]
    n_trees = draws.cand_f.shape[0]
    width = 2 ** (max_depth - 1)
    if draws.poisson is not None:
        w = base_w[None] * draws.poisson.to(dev, x.dtype)
    else:
        w = base_w[None].expand(n_trees, n).contiguous()
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=dev)
    feats, thrs = [], []
    for level in range(max_depth):
        cand_f = draws.cand_f[:, level].to(dev)
        # the threshold: the midpoint of two random examples' values
        cand_t = (x[draws.r1[:, level].to(dev), cand_f]
                  + x[draws.r2[:, level].to(dev), cand_f]) * 0.5
        # node ids at level l stay below 2**l <= width: the tables' tails are never read
        f, t, node = _grow_level(x, y, w, node, cand_f, cand_t, width, n_classes)
        feats.append(f)
        thrs.append(t)
    n_leaves = 2 ** max_depth
    counts = segment_sum(w, node * n_classes + y[None], n_leaves * n_classes)
    counts = counts.reshape(n_trees, n_leaves, n_classes)
    # Laplace smoothing toward the class prior: an empty leaf reads the prior
    prior = segment_sum(base_w[None], y[None], n_classes)[0]
    prior = prior / torch.clamp(prior.sum(), min=1e-9)
    leaf_probs = ((counts + prior[None, None, :])
                  / torch.clamp(counts.sum(-1, keepdim=True) + 1.0, min=1e-9))
    return Forest(torch.stack(feats, 1).to(torch.int32), torch.stack(thrs, 1), leaf_probs)


@torch.no_grad()
def _predict_proba(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """The mean over trees of each example's leaf distribution
    (counterpart: forest.py:133)."""
    n_trees, depth, _ = forest.feats.shape
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)[None]
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=x.device)
    feats = forest.feats.to(torch.int64)
    for level in range(depth):
        f = torch.gather(feats[:, level], 1, node)
        t = torch.gather(forest.thrs[:, level], 1, node)
        node = node * 2 + (~(x[rows, f] <= t)).to(node.dtype)
    probs = torch.gather(forest.leaf_probs, 1,
                         node[..., None].expand(-1, -1, forest.leaf_probs.shape[2]))
    return probs.mean(0)


class RandomForest:
    """sklearn-shaped forest (counterpart: forest.py:151).
    ``class_weight="balanced"`` weighs each example ``n / (n_classes x
    bincount(y))`` before the bootstrap, as sklearn does. The arithmetic
    runs on ``device`` (default the CUDA card; the CPU only when named)."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 10, n_candidates: int = 32,
                 class_weight=None, bootstrap: bool = True, random_state: int = 0,
                 device="auto"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.n_candidates = n_candidates
        self.class_weight = class_weight
        self.bootstrap = bootstrap
        self.random_state = random_state
        self.device = resolve_device(device)
        self.forest: Optional[Forest] = None

    def fit(self, x, y, draws: Optional[ForestDraws] = None):
        """Grow the forest on ``x`` (n, feats) and integer labels ``y``;
        ``draws`` replaces :func:`forest_draws` (parity tests pass JAX's)."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y_np = np.asarray(y).astype(np.int32)
        self.classes_ = np.unique(y_np)
        n_classes = int(self.classes_.max()) + 1
        if self.class_weight == "balanced":
            counts = np.bincount(y_np, minlength=n_classes).astype(np.float32)
            base_w = (len(y_np) / (len(self.classes_) * np.maximum(counts, 1.0)))[y_np]
        else:
            base_w = np.ones(len(y_np), np.float32)
        if draws is None:
            draws = forest_draws(self.random_state or 0, self.n_estimators, x.shape[0],
                                 x.shape[1], self.max_depth, self.n_candidates, self.bootstrap)
        self.forest = _fit_forest(x, torch.as_tensor(y_np.astype(np.int64), device=self.device),
                                  torch.as_tensor(np.asarray(base_w, np.float32),
                                                  device=self.device),
                                  draws, self.max_depth, n_classes)
        self._n_classes = n_classes
        return self

    def predict_proba(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return _predict_proba(self.forest, x).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self.predict_proba(x).argmax(1)


__all__ = ["Forest", "ForestDraws", "RandomForest", "forest_draws", "segment_sum"]
