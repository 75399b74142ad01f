"""The walk of ``csrc/pool_scan.cu`` as a Python model, held bit for bit
against the scan's plain version on the CPU, on the one input whose
outcome rests on a step of the walk's design rather than on the row
event: a fire that makes later rows candidates.

The kernel never steps a row that cannot change the pool.  A warp takes
a stage of 16 groups of 32 rows, finds the groups that hold a candidate
(valid, and a MIPS below the pool or, under v2, the armed timer due)
under the carry, and visits only those: in each it ballots the
candidates, applies the first one's event and ballots again over the
rows after it, or walks the whole group row by row when it holds
``SERIAL_FROM`` candidates or more; after a fire it tests the stage's
later groups again.  The model does the same in float32 (single-rounded
adds held in Python floats).  The kernel itself is held against the
plain version on every kind of ``scenarios.pool_scan_inputs`` by the
card tests (``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch.ops.pool_kernels import local_pool_scan_plain
from fognetsimpp_tpu_torch.scenarios.pool_scan_inputs import rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: Rows of a stage: 16 groups of 32 (``kStage`` in the source).
STAGE = 512
#: Candidates from which a group is walked row by row (``kSerialFrom``).
SERIAL_FROM = 8


def _f32(x):
    return float(np.float32(x))


def _warp_walk(m, v, t, pool0, fire_t0, refund0, v2):
    """One world's scan as the kernel's warp walks it."""
    K = len(m)
    c = {"pool": pool0, "armed": v2 and math.isfinite(fire_t0), "fired": False}
    if K:  # v2's + 0.0 folds -0.0 into +0.0; v1's - 0.0 keeps it
        c["pool"] = _f32(c["pool"] + 0.0) if v2 else _f32(c["pool"] - 0.0)

    def candidate(k):
        return v[k] and (m[k] < c["pool"] or (v2 and c["armed"] and t[k] >= fire_t0))

    def apply_row(k, vk):
        if v2:
            fire_now = c["armed"] and vk and t[k] >= fire_t0
            if fire_now:
                c["pool"] = _f32(c["pool"] + refund0)
            c["fired"] = c["fired"] or fire_now
            c["armed"] = c["armed"] and not fire_now
        tk = vk and m[k] < c["pool"]
        if tk:
            c["pool"] = _f32(c["pool"] - m[k])
        if v2:
            c["armed"] = c["armed"] and not tk
        return tk

    def candidate_groups(c0, first):
        return [g0 for g0 in range(c0 + 32 * first, min(c0 + STAGE, K), 32)
                if any(candidate(k) for k in range(g0, min(g0 + 32, K)))]

    take = [False] * K
    for c0 in range(0, K, STAGE):
        groups = candidate_groups(c0, 0)
        while groups:
            g0 = groups.pop(0)
            fired = c["fired"]
            lanes = range(g0, min(g0 + 32, K))
            cand = [k for k in lanes if candidate(k)]
            if len(cand) >= SERIAL_FROM:
                for k in lanes:
                    take[k] = apply_row(k, v[k])
            else:
                while cand:
                    k = cand[0]
                    take[k] = apply_row(k, True)
                    cand = [j for j in lanes if j > k and candidate(j)]
            if c["fired"] != fired:  # the pool grew: test the later groups again
                groups = candidate_groups(c0, (g0 - c0) // 32 + 1)
    return take, c["pool"], c["fired"]


def test_warp_walk_retests_after_a_fire():
    """``unsorted_fire``: times fall, so the timer is due at the first
    valid row and its refund of 1e6 makes every later row a candidate,
    which none was under the pool of 50 the stage was first tested with."""
    R, K = 3, 1100  # three stages, the last one partial
    win = rows("unsorted_fire", R, K, seed=7)
    want = local_pool_scan_plain(*[torch.from_numpy(np.asarray(a)) for a in win], True)
    mips, valid, t, pool0, fire_t0, refund0 = (np.asarray(a).tolist() for a in win)
    for r in range(R):
        take, pool, fired = _warp_walk(mips[r], valid[r], t[r], pool0[r], fire_t0[r],
                                       refund0[r], True)
        assert take == want[0][r].tolist()
        assert np.float32(pool).tobytes() == want[1][r].numpy().tobytes()
        assert fired == bool(want[2][r])
    assert bool(want[2].all()) and int(want[0].sum()) > 0
