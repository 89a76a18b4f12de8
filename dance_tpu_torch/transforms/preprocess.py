"""Pairwise constraints for scDCC (counterpart: ``generate_random_pair``,
dance_tpu/transforms/preprocess.py:202-237).

The JAX function draws from Python's global ``random`` and numpy's global
``np.random``; this copy makes the same calls in the same order, so after
``random.seed(s)`` and ``np.random.seed(s)`` both give the same pairs.
"""

import random

import numpy as np


def generate_random_pair(y, label_cell_indx, num, error_rate=0):
    """Random must-link / cannot-link pairs from labels ``y`` over the cells
    ``label_cell_indx``: ``num`` draws of two distinct cells, a same-label
    pair a must-link (each ordered pair once) and any other a cannot-link,
    the first ``error_rate · num`` draws flipped to simulate noisy
    supervision. Returns ``(ml_ind1, ml_ind2, cl_ind1, cl_ind2,
    error_num)``, each list in a random order."""
    y = np.asarray(y)
    label_cell_indx = list(label_cell_indx)
    ml_ind1, ml_ind2, cl_ind1, cl_ind2 = [], [], [], []
    seen_ml = set()
    error_num = 0
    num0 = num
    while num > 0:
        tmp1 = random.choice(label_cell_indx)
        tmp2 = random.choice(label_cell_indx)
        if tmp1 == tmp2 or (tmp1, tmp2) in seen_ml:
            continue
        flip = error_num < error_rate * num0
        if (y[tmp1] == y[tmp2]) != flip:  # a true pair kept, or a flipped link
            ml_ind1.append(tmp1)
            ml_ind2.append(tmp2)
            seen_ml.add((tmp1, tmp2))
        else:
            cl_ind1.append(tmp1)
            cl_ind2.append(tmp2)
        if flip:
            error_num += 1
        num -= 1
    ml_ind1, ml_ind2 = np.array(ml_ind1, int), np.array(ml_ind2, int)
    cl_ind1, cl_ind2 = np.array(cl_ind1, int), np.array(cl_ind2, int)
    ml_perm = np.random.permutation(len(ml_ind1))
    cl_perm = np.random.permutation(len(cl_ind1))
    return (ml_ind1[ml_perm], ml_ind2[ml_perm], cl_ind1[cl_perm], cl_ind2[cl_perm], error_num)


__all__ = ["generate_random_pair"]
