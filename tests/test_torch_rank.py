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
    got = tr.rank_pass1(torch.from_numpy(pats), torch.from_numpy(wins),
                        torch.from_numpy(wlen), split=H // 2)
    assert got[0].shape == (H, P)
    _same(got, want)
