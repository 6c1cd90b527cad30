"""Property-style fuzz of the port's engine against the scalar oracle,
row for row, across random query groups, read shapes and engine
switches (the counterpart of tests/test_engine_fuzz.py): odd barcode
counts, short and long flanks, extreme alpha and score thresholds,
empty and tiny reads, the one-blob or separate uploads and power-of-two
or 1/8-octave row buckets; and the sticky hit-capacity retry on one
device and on a two-device mesh."""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu_torch.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu_torch.models.demux import Demuxer  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.models.records import BarcodeType  # noqa: E402
from barbell_tpu_torch.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu_torch.utils import dna  # noqa: E402


def _rand_seq(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _make_group(rng, n_bars, bar_len, pre_len, suf_len, btype):
    pre = _rand_seq(rng, pre_len)
    suf = _rand_seq(rng, suf_len)
    seqs = [pre + _rand_seq(rng, bar_len) + suf for _i in range(n_bars)]
    labels = [f"B{i:02d}" for i in range(n_bars)]
    return BarcodeGroup.from_seqs(seqs, labels, btype)


@pytest.mark.parametrize("trial", range(6))
def test_engine_fuzz_matches_oracle(trial):
    rng = random.Random(100 + trial)
    n_bars = rng.choice([2, 3, 7, 13])
    bar_len = rng.choice([12, 20, 31])
    pre_len = rng.choice([5, 9, 16])
    suf_len = rng.choice([8, 21, 40])
    btype = rng.choice([BarcodeType.Ftag, BarcodeType.Rtag])
    alpha = rng.choice([0.0, 0.2, 0.4, 0.9, 1.0])
    min_score = rng.choice([0.0, 0.2, 0.5])
    min_score_diff = rng.choice([0.0, 0.1, 0.3])

    group = _make_group(rng, n_bars, bar_len, pre_len, suf_len, btype)
    group.set_flank_threshold(max(1, get_edit_cut_off(group.get_effective_len())))

    engine = TorchDemuxEngine([group], alpha=alpha, min_score=min_score,
                              min_score_diff=min_score_diff, device="cpu")
    # the wire and shape paths too: the one-blob or separate uploads and
    # power-of-two or 1/8-octave row buckets must all give the same rows
    engine.mono_upload = rng.random() < 0.5
    engine.fine_rows = rng.random() < 0.5
    d = Demuxer(alpha=alpha, min_score=min_score, min_score_diff=min_score_diff)
    d.add_query_group(group)

    ids, seqs = [], []
    for i in range(10):
        kind = rng.randrange(6)
        # the padded barcode slice is a true subsequence of its query
        q = group.barcodes[rng.randrange(n_bars)].seq
        body = _rand_seq(rng, rng.randrange(0, 400))
        if kind == 0:
            seq = b""  # empty read
        elif kind == 1:
            seq = _rand_seq(rng, rng.randrange(1, 30))  # tiny random
        elif kind == 2:
            seq = q + body  # construct at the start
        elif kind == 3:
            seq = dna.reverse_complement_bytes(q) + body
        elif kind == 4:
            seq = body[: len(body) // 2] + q + body[len(body) // 2 :]
        else:
            seq = q[rng.randrange(0, max(1, len(q) // 2)) :] + body  # truncated
        ids.append(f"t{trial}_{i}")
        seqs.append(seq)

    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        want = d.demux(rid, seq)
        assert rows == want, (trial, rid, rows, want)


@pytest.mark.parametrize("sharded", [False, True])
def test_hit_overflow_retry_is_sticky(sharded):
    """Reads with many constructs overflow the first hit capacity (the
    padded row count): the first batch retries once at a larger
    capacity (on every shard) and equals the oracle, and the larger
    capacity sticks: the next batch dispatches at it directly."""
    rng = random.Random(7)
    group = _make_group(rng, 3, 16, 8, 12, BarcodeType.Ftag)
    group.set_flank_threshold(max(1, get_edit_cut_off(group.get_effective_len())))
    devices = ["cpu"] * (2 if sharded else 1)
    D = len(devices)
    # the capacity is per shard: each shard needs several dense reads
    n_reads = 4 * D
    engine = TorchDemuxEngine([group], devices=devices)
    d = Demuxer(alpha=0.4, min_score=0.2, min_score_diff=0.1)
    d.add_query_group(group)

    calls = []
    orig = engine._dispatch

    def counting(gplans, batch, H_cap):
        calls.append(H_cap)
        return orig(gplans, batch, H_cap)

    engine._dispatch = counting

    def make_batch(seed):
        r = random.Random(seed)
        ids, seqs = [], []
        for i in range(n_reads):
            parts = []
            for _ in range(12):  # 12 constructs a read >> rows a read
                q = group.barcodes[r.randrange(3)].seq
                parts.append(q + _rand_seq(r, 30))
            ids.append(f"s{seed}_{i}")
            seqs.append(b"".join(parts))
        return ids, seqs

    ids1, seqs1 = make_batch(1)
    got1 = engine.demux_batch(ids1, seqs1)
    assert engine._h_cap_hint > 0, "overflow retry did not set the hint"
    assert len(calls) == 2 * D and calls[D] > calls[0], calls
    assert calls[:D] == [calls[0]] * D and calls[D:] == [calls[D]] * D, calls

    ids2, seqs2 = make_batch(2)
    got2 = engine.demux_batch(ids2, seqs2)
    assert calls[2 * D:] == [engine._h_cap_hint] * D, calls

    for rid, seq, rows in zip(ids1 + ids2, seqs1 + seqs2, got1 + got2):
        assert rows == d.demux(rid, seq), rid
