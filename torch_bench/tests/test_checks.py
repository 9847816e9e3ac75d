"""Each cell's check, driven through a whole run at a small size on the CPU:
a sound run is correct; the control (the reference in TF32 in the
program's place, emulated here by rounding every convolution's operands)
and each fault the cell can have, planted under the timed path, are not."""

import math

import pytest

CELLS = ["infer.grid-c8", "gan.train-b32", "gan.hg-b5", "infer.serve-open"]
FAULTS = [("infer.grid-c8", "answer"), ("infer.grid-c8", "half_batch"),
          ("infer.serve-open", "answer"),
          ("gan.train-b32", "unchanged"), ("gan.train-b32", "half_batch"),
          ("gan.hg-b5", "unchanged"), ("gan.hg-b5", "half_batch")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(run_small, cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(run_small, cell):
    res = run_small(cell, control="tf32")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(run_small, cell, fault):
    res = run_small(cell, fault=fault)
    assert not res["correct"], res["checks"]
    if fault == "unchanged":  # the change's gap reads 1 by its measure
        assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gan.train-b32", "gan.hg-b5"])
def test_a_fault_from_the_window_on_is_not_correct(run_small, monkeypatch, cell):
    """The steps compared are the window's: a step that leaves out half of
    each batch only once the warm-up's epoch is over is caught."""
    from torch_bench.drivers import train

    build = train.build_program

    def late(run, states):
        step, models = build(run, states)
        warm = math.ceil(round(run.traffic["tiles"] * run.traffic.get("split", 1.0))
                         / run.config["batch_size"][run.traffic["step"]])
        calls = []

        def broken(batch):
            calls.append(1)
            if len(calls) > warm:
                batch = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(batch)

        return broken, models

    monkeypatch.setattr(train, "build_program", late)
    res = run_small(cell)
    assert not res["correct"], res["checks"]
