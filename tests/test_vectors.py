"""Reference test-vector parity (SURVEY.md §4.6 drop-in slot).

Runs every vector in tests/vectors/*.jsonl against the oracle and the
device engine; skips cleanly when no vectors are present (the reference
mount was empty at survey time, SURVEY.md §0)."""

import glob
import json
import os

import pytest

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def _load_vectors():
    vecs = []
    for path in sorted(glob.glob(os.path.join(VEC_DIR, "*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    vecs.append(json.loads(line))
    return vecs


VECTORS = _load_vectors()


@pytest.mark.parametrize("backend", ["oracle", "xla"])
def test_reference_vectors(backend):
    if not VECTORS:
        pytest.skip("no reference vectors present (empty mount, SURVEY.md §0)")
    import seqalib as sa

    for v in VECTORS:
        sp = sa.ScoringParams(**v["scoring"])
        res = sa.align(
            v["query"], v["target"], scoring=sp, mode=v["mode"], backend=backend
        )
        assert res.score == v["score"], v
        if v.get("cigar"):
            assert res.cigar == v["cigar"], v
