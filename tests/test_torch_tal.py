"""The port's task-aligned assigner against the JAX package's, f32 on the CPU.

Inputs come from a seed through numpy: anchors of a 64 px image at strides 8,
16 and 32 (84 anchors), GT rows with some padding, and predicted scores and
boxes. Three cases: random predictions; deliberately tied metrics (every
anchor predicts the same box and score, so every candidate of a GT ties, and
two GTs share a box, so their overlaps tie too); and predictions that miss
every GT, so the candidates' metrics are all 0 and the top k is decided by
ties alone (JAX :47-53: metric-0 anchors of a real GT are candidates).

target_labels, fg_mask, target_gt_idx and target_bboxes must be equal;
target_scores within 1e-6 (JAX raises to alpha and beta with XLA's pow, the
port with torch's, which round differently in the last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_yolov11_torch.ops.decode import make_anchors
from spectrogram_yolov11_torch.ops.tal import select_topk_candidates, task_aligned_assign
from spectrogram_yolov11_tpu.ops.tal import select_topk_candidates as jax_select_topk_candidates
from spectrogram_yolov11_tpu.ops.tal import task_aligned_assign as jax_task_aligned_assign

NC, B, G = 3, 2, 5
SCORES_TOL = 1e-6


def _inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    anchors, strides = make_anchors([(8, 8), (4, 4), (2, 2)], (8.0, 16.0, 32.0))
    anc = (anchors * strides).numpy()  # pixels
    a = len(anc)
    xy = rng.uniform(8, 56, (B, G, 2))
    wh = rng.uniform(6, 40, (B, G, 2))
    gt = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, G, 1)).astype(np.int32)
    mask = np.ones((B, G, 1), bool)
    mask[0, 4:] = mask[1, 3:] = False
    gt[~mask[..., 0]] = 0
    if case == "random":
        scores = rng.uniform(0.01, 0.99, (B, a, NC)).astype(np.float32)
        c = anc[None] + rng.normal(0, 4, (B, a, 2))
        half = rng.uniform(4, 24, (B, a, 2))
        boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    elif case == "tied":
        scores = np.full((B, a, NC), 0.5, np.float32)
        boxes = np.broadcast_to(np.array([16, 16, 48, 48], np.float32), (B, a, 4)).copy()
        gt[:, 1] = gt[:, 0]  # two GTs with one box: equal overlaps everywhere
    else:  # "missed": every prediction lies outside every GT
        scores = rng.uniform(0.01, 0.99, (B, a, NC)).astype(np.float32)
        boxes = np.broadcast_to(np.array([200, 200, 210, 210], np.float32), (B, a, 4)).copy()
    return scores, boxes, anc.astype(np.float32), labels, gt, mask


@pytest.mark.parametrize("case", ["random", "tied", "missed"])
def test_assign_equals_jax(case):
    scores, boxes, anc, labels, gt, mask = _inputs(case)
    ref = jax_task_aligned_assign(*(jnp.asarray(x) for x in (scores, boxes, anc, labels, gt, mask)), topk=10,
                                  num_classes=NC)
    got = task_aligned_assign(*(torch.from_numpy(x) for x in (scores, boxes, anc, labels, gt, mask)), topk=10,
                              num_classes=NC)
    for name in ("target_labels", "fg_mask", "target_gt_idx", "target_bboxes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores), atol=SCORES_TOL, rtol=0)
    n_fg = int(got.fg_mask.sum())
    assert n_fg > 0
    if case == "tied":  # the tie-break decided: every GT's 10 anchors are the lowest-index candidates
        assert (got.target_gt_idx[got.fg_mask] != 1).all()  # GT 0 wins its shared box's anchors
    print(f"{case}: {n_fg} fg anchors, max |target_scores diff| "
          f"{np.abs(got.target_scores.numpy() - np.asarray(ref.target_scores)).max():.1e}")


def test_topk_breaks_ties_to_the_lowest_index_as_jax():
    rng = np.random.default_rng(3)
    metrics = rng.integers(0, 3, (2, 4, 40)).astype(np.float32)  # values 0, 1, 2: ties everywhere
    mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1]], bool)
    got = select_topk_candidates(torch.from_numpy(metrics), 10, torch.from_numpy(mask))
    ref = jax_select_topk_candidates(jnp.asarray(metrics), 10, jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum() == 10 * mask.sum()
