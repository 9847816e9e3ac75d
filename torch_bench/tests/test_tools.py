"""The benchmark's command takes the contract's options alone; the limits'
readings (torch_bench/readings.py) and the knee sweep
(torch_bench/sweep.py) drive whole runs of a cell at a small size."""

import json
import math

import pytest
import torch

CPU = torch.device("cpu")


def test_the_command_takes_the_contract_options_alone():
    from torch_bench.run import parse

    args = parse(["--workload", "infer.grid-c8", "--seed", str(2**31 + 5), "--seconds", "10",
                  "--trace", "1"])
    assert vars(args) == {"workload": "infer.grid-c8", "seed": 2**31 + 5, "seconds": 10.0,
                          "trace": 1}
    for extra in (["--set", "rate=1"], ["--control", "tf32"], ["--fault", "answer"]):
        with pytest.raises(SystemExit):
            parse(["--workload", "infer.grid-c8", "--seed", "1", "--seconds", "1", *extra])


def test_readings_take_the_program_and_the_control_over_seeds(small):
    from torch_bench import readings

    cell = "gan.hg-b5"
    program = readings.read(cell, [21, 22], 0.5, device=CPU, overrides=small[cell])
    control = readings.read(cell, [21], 0.5, control="tf32", device=CPU, overrides=small[cell])
    lower, upper = readings.summary(program), readings.summary(control)
    assert set(lower) == set(upper) == {"loss_gap", "grad_gap", "update_gap"}
    assert all(0 <= lo <= hi < math.inf for lo, hi in lower.values())
    # the control reads above the program's largest in some number
    assert any(upper[n][1] > lower[n][1] for n in lower)
    assert [seed for seed, _, _ in program] == [21, 22]


def test_the_sweep_changes_the_rate_alone(small):
    from torch_bench import sweep

    cell = "infer.serve-open"
    rows = sweep.sweep(cell, [6, 12], 31, 2.0, device=CPU, overrides=small[cell])
    assert [r["rate"] for r in rows] == [6, 12]
    for r in rows:
        assert r["correct"] and r["failed"] == 0
        assert r["p50_ms"] <= r["p95_ms"] < math.inf
        assert set(sweep.KEYS) <= set(r)
    assert rows[1]["offered_per_s"] > rows[0]["offered_per_s"]


def test_the_sweep_runs_a_process_a_rate(capsys):
    from torch_bench import sweep

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the runs would measure")
    sweep.main(["--workload", "infer.serve-open", "--seed", "1", "--seconds", "1", "--rates", "5", "6"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["rate"] for r in rows] == [5.0, 6.0]
    assert all(r["rc"] != 0 for r in rows)  # each a process of its own: no result here
