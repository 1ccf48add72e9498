"""Top-k comparisons of staged searches whose prune cuts may break ties
differently; imports no JAX, so tests on the card can use it too."""

import numpy as np

RTOL, ATOL = 1e-5, 1e-4


def _assert_same_topk_but_cut_ties(ours, ref, cut_ties):
    """Score-sorted top-k equal with a tie tolerance at the k-th score; a doc
    in one list only must be a prune-cut tie of its query, or score at most
    the other list's k-th score (a doc pushed out by such a tie)."""
    for o, r, tied in zip(ours, ref, cut_ties):
        assert len(o.passage_ids) == len(r.passage_ids) == 10
        o_map, r_map = dict(zip(o.passage_ids, o.scores)), dict(zip(r.passage_ids, r.scores))
        for doc in set(o_map) & set(r_map):
            assert abs(o_map[doc] - r_map[doc]) <= ATOL + RTOL * abs(r_map[doc])
        for doc in set(o_map) ^ set(r_map):
            score = o_map.get(doc, r_map.get(doc))
            other_kth = (r if doc in o_map else o).scores[-1]
            assert doc in tied or score <= other_kth + ATOL + RTOL * abs(other_kth), (
                doc, score, other_kth, tied)
        if not tied:
            np.testing.assert_allclose(o.scores, r.scores, rtol=RTOL, atol=ATOL)
