"""The window's plumbing against the port on the CPU, at a tiny size: a
whole run of a cell added as files alone (feeder, pipes, the timed call,
digester, reference, comparison), sound and with the timed path broken
underneath; the control at a test's size; and, on a card, one short run
of each cell."""

from __future__ import annotations

import pytest

from benchmark import run as harness
from benchmark.cells import load_cell


def _half_batches(monkeypatch):
    from barbell_tpu_torch.utils import fastx_native

    real = fastx_native.iter_fastq_batches_auto

    def half(paths, batch_size):
        for batch in real(paths, batch_size):
            yield batch[: len(batch) // 2]

    monkeypatch.setattr(fastx_native, "iter_fastq_batches_auto", half)


def _unchanged(monkeypatch):
    from barbell_tpu_torch.models import pipeline

    def nothing(engine, batches, *a, **k):
        for _b in batches:
            pass
        return iter(())

    monkeypatch.setattr(pipeline, "engine_map_batches", nothing)


def _altered(monkeypatch):
    from barbell_tpu_torch.models import hittable

    real = hittable.emit_tsv_lines

    def altered(table):
        out = []
        for line in real(table):
            f = line.split("\t")
            f[4] = str(int(f[4]) + 1)  # read_end_bar one base off
            out.append("\t".join(f))
        return out

    monkeypatch.setattr(hittable, "emit_tsv_lines", altered)


def _reordered(monkeypatch):
    from barbell_tpu_torch.models import pipeline

    real = pipeline.engine_map_batches

    def swapped(engine, batches, *a, **k):
        held = None
        for item in real(engine, batches, *a, **k):
            if held is None:
                held = item
            else:
                yield item
                yield held
                held = None
        if held is not None:
            yield held

    monkeypatch.setattr(pipeline, "engine_map_batches", swapped)


FAULTS = {"sound": None, "half_of_each_batch_left_out": _half_batches,
          "state_returned_unchanged": _unchanged, "answer_altered": _altered,
          "batches_out_of_order": _reordered}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_window_on_cpu(tiny_root, monkeypatch, fault):
    pytest.importorskip("barbell_tpu_torch")
    cell = load_cell("dummy.tiny", tiny_root)
    plant = FAULTS[fault]
    # the fault goes in after the warm-up: the timed call alone is broken
    res = harness.run(cell, 2**31 + 77, 3.0, trace=False, device="cpu", device_name="cpu",
                      root=tiny_root, workers=1,
                      timed_hook=(lambda: plant(monkeypatch)) if plant else None)
    assert res["attempted"] > cell.traffic["pool_reads"]
    assert res["correct"] is (fault == "sound"), res["compared"]
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("cell", ["rbk114_96.ends", "nbd114_96.ends"])
def test_control_fails_the_comparison(cell):
    from benchmark.control import control_reading

    c = load_cell(cell)
    c.traffic["pool_reads"] = 256
    r = control_reading(c, 2**31 + 5, "int16", workers=1, sample=3, passes=2)
    # the run's own comparison, with the control in the program's place
    assert r["correct"] is False and r["compared_read_instances"] == 6
    assert r["compared"]["mismatched_reads"]["value"] > r["compared"]["mismatched_reads"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["rbk114_96.ends", "nbd114_96.ends", "rbk114_96.full_scan"])
def test_cell_on_the_card(card, cell):
    import torch

    c = load_cell(cell)
    res = harness.run(c, 2**31 + 5, 3.0, trace=True, device="cuda",
                      device_name=torch.cuda.get_device_name(0))
    assert res["correct"], res["compared"]
    assert not res["side_process_limit"]
    assert res["device"]["busy_s"] > 0
