"""The port's barcode rank (plain PyTorch version, which the CUDA wrapper
runs for CPU tensors) against the Pallas kernel in interpret mode, in
both forms: valley keys must be equal integers and Lodhi scores equal
bit for bit (compared as int32 views)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops.pallas_rank import rank_pass1, rank_pass1_split  # noqa: E402
from barbell_tpu_torch.ops import rank as tr  # noqa: E402

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)


def _cases(rng, H, Pa, m, W):
    pats = BASES[rng.integers(0, 4, size=(Pa, m))]
    pats[rng.integers(0, Pa), rng.integers(0, m)] = 15  # IUPAC N
    wins = np.zeros((H, W), dtype=np.uint8)
    wlen = rng.integers(m // 2, W + 1, H).astype(np.int32)
    wlen[0] = 0  # empty lane
    for h in range(1, H):
        n = int(wlen[h])
        content = BASES[rng.integers(0, 4, size=n)]
        p = pats[rng.integers(0, Pa)].copy()
        p[rng.integers(0, m)] = BASES[rng.integers(0, 4)]
        pos = int(rng.integers(0, max(1, n - m)))
        content[pos : pos + m] = p[: min(m, n - pos)]
        wins[h, :n] = content
    return pats, wins, wlen


def _same(got, want):
    key, lod = got
    wkey, wlod = (np.asarray(a) for a in want)
    assert key.dtype == torch.int32 and lod.dtype == torch.float32
    assert np.array_equal(key.numpy(), wkey)
    assert np.array_equal(lod.numpy().view(np.int32), wlod.view(np.int32))


@pytest.mark.parametrize("H,Pa,m,W", [(10, 12, 9, 21), (6, 5, 14, 40)])
def test_rank_plain_matches_pallas(H, Pa, m, W):
    rng = np.random.default_rng(H * 100 + m)
    pats, wins, wlen = _cases(rng, H, Pa, m, W)
    want = rank_pass1(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(wlen), interpret=True
    )
    got = tr.rank_pass1(torch.from_numpy(pats), torch.from_numpy(wins),
                        torch.from_numpy(wlen))
    _same(got, want)


def test_rank_split_plain_matches_pallas():
    rng = np.random.default_rng(3)
    H, P, m, W = 256, 3, 9, 19
    pats, wins, wlen = _cases(rng, H, 2 * P, m, W)
    want = rank_pass1_split(
        jnp.asarray(pats), P, jnp.asarray(wins), jnp.asarray(wlen),
        interpret=True,
    )
    got = tr.rank_pass1_split(torch.from_numpy(pats), torch.from_numpy(wins),
                              torch.from_numpy(wlen), H // 2)
    assert got[0].shape == (H, P)
    _same(got, want)


def _edge_lanes(rng, pats, H, W):
    """Windows holding a noisy pattern copy each, and the lanes the
    kernel's early exit turns on: ``w_len`` 0, exactly W, and past W."""
    wins = BASES[rng.integers(0, 4, size=(H, W))]
    wlen = rng.integers(0, W + 1, H).astype(np.int32)
    for h in range(H):
        p = pats[rng.integers(0, len(pats))]
        pos = int(rng.integers(0, max(1, W - len(p) + 1)))
        seg = p[: W - pos]
        wins[h, pos : pos + len(seg)] = seg
        wins[h, wlen[h]:] = 0
    wlen[:4] = 0, W, W + 1, W + 40
    return wins, wlen


@pytest.mark.parametrize(
    "H,Pa,m,W,split",
    [
        (7, 4, 1, 13, 0),  # one-row patterns
        (9, 6, 5, 17, 0),  # odd W (zero-padded to even)
        (11, 6, 6, 5, 0),  # window shorter than the pattern
        (13, 6, 5, 15, 5),  # strand split at an odd lane
    ],
    ids=["m1", "odd_w", "w_lt_m", "odd_split"],
)
def test_rank_edge_cases_match_pallas(H, Pa, m, W, split):
    """Edge cases of the CUDA kernel's wavefront and early exit, held on
    the plain version: lanes with ``w_len`` 0, W and past W in every
    case.  The split form at an odd lane is held against the Pallas
    non-split kernel's columns of each lane's strand (the Pallas split
    form splits only at H / 2 on a 256-lane tile)."""
    rng = np.random.default_rng(1000 + 10 * m + W)
    pats = BASES[rng.integers(0, 4, size=(Pa, m))]
    pats[rng.integers(0, Pa), rng.integers(0, m)] = 15
    wins, wlen = _edge_lanes(rng, pats, H, W)
    want = rank_pass1(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(wlen), interpret=True
    )
    if split:
        P = Pa // 2
        rc = (np.arange(H) >= split)[:, None]
        want = tuple(np.where(rc, np.asarray(a)[:, P:], np.asarray(a)[:, :P])
                     for a in want)
        got = tr.rank_pass1_split(torch.from_numpy(pats), torch.from_numpy(wins),
                                  torch.from_numpy(wlen), split)
    else:
        got = tr.rank_pass1(torch.from_numpy(pats), torch.from_numpy(wins),
                            torch.from_numpy(wlen))
    _same(got, want)
    # a w_len = 0 lane scores m * UNIT at position 0 with Lodhi 0
    assert (got[0][0] == m * tr.UNIT * 256).all() and (got[1][0] == 0).all()


@pytest.mark.parametrize("m", [1, 9, 17, 44, 90, 128, 512])
def test_rank_plan_covers_pattern(m):
    """The kernel's (rows, group) choice: a template instance, a
    power-of-two group within a warp, enough rows for the pattern."""
    for W in (2, 22, 66, 254):
        R, G = tr.plan(m, W)
        assert R in tr.ROWS and G in (1, 2, 4, 8, 16, 32) and G * R >= m
    assert tr.plan(44, 66) == (11, 4)
