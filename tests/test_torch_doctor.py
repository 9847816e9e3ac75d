"""The port's doctor (cli/doctor.py), a port of tests/test_doctor.py.

Here, on the CPU: ``--cpu`` passes every row that is not SKIP, a
failing row sets exit code 1, and without ``--cpu`` and without CUDA
the backend row FAILs. ``--inspect`` prints the JAX doctor's JSON on a
JAX-written master checkpoint, a raw state dict and an unrecognised
object. On a card, tests/test_torch_cuda.py runs ``doctor.main([])``.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from terra_gan_tpu.cli import doctor as jax_doctor
from terra_gan_tpu_torch.cli import doctor


def rows(out: str):
    """(status, name) of each row the doctor printed."""
    return [(ln[3:7].strip(), ln[9:].split(" — ")[0]) for ln in out.splitlines()
            if ln.startswith("  [")]


class TestChecks:
    def test_cpu_passes_every_row_that_is_not_skipped(self, capsys):
        assert doctor.main(["--cpu"]) == 0
        out = capsys.readouterr().out
        assert rows(out) == [
            ("PASS", "versions"), ("PASS", "backend"), ("SKIP", "kernel-build"),
            ("SKIP", "native"), ("PASS", "model"), ("SKIP", "probes"), ("SKIP", "quant"),
            ("SKIP", "mesh"), ("PASS", "config")]
        assert "9 checks: 4 pass, 0 warn, 0 fail, 5 skip" in out
        assert "kernel-build — cpu requested" in out and "not ported yet" in out

    def test_failing_check_sets_exit_code(self, monkeypatch, capsys):
        def boom(cpu):
            raise RuntimeError("synthetic failure")

        monkeypatch.setattr(doctor, "_check_model", boom)
        assert doctor.main(["--cpu"]) == 1
        out = capsys.readouterr().out
        assert "[FAIL] model — RuntimeError: synthetic failure" in out
        assert "1 fail" in out

    def test_without_cpu_and_without_cuda_the_backend_fails(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        assert doctor.main([]) == 1
        out = capsys.readouterr().out
        assert ("FAIL", "backend") in rows(out)
        assert "CUDA is not available" in out

    def test_a_bad_config_fails_its_row(self, tmp_path, capsys):
        bad = tmp_path / "bad.yaml"
        bad.write_text("training: &anchor\n  remat: true\n")
        assert doctor.main(["--cpu", "--config", str(bad)]) == 1
        out = capsys.readouterr().out
        assert "[FAIL] config — ValueError: yaml_lite: line 1: anchors" in out

    def test_report_rows_warn_and_skip_by_prefix(self, capsys):
        r = doctor._Report()
        r.run("a", lambda: "WARN: careful")
        r.run("b", lambda: "SKIP: later")
        r.run("c", lambda: None)
        assert r.rows == [("a", "WARN", "careful"), ("b", "SKIP", "later"), ("c", "PASS", "")]
        assert not r.failed


def inspect_both(path, capsys):
    """(exit code, JSON) of the JAX doctor's --inspect and of the port's."""
    out = []
    for module in (jax_doctor, doctor):
        code = module.main(["--inspect", str(path)])
        out.append((code, json.loads(capsys.readouterr().out)))
    return out


class TestInspect:
    def test_reference_layout_pth(self, tmp_path, capsys):
        from terra_gan_tpu.models import Discriminator, PConvUNet
        from terra_gan_tpu.training import GANTrainState
        from terra_gan_tpu.training.checkpoint import export_pth

        state = GANTrainState.create(
            PConvUNet(base_width=8), Discriminator(base_width=8),
            jax.random.PRNGKey(0), sample_shape=(1, 32, 32, 1),
        )
        path = tmp_path / "master.pth"
        export_pth(path, state, epoch=7, extra={"vgg_weights_provenance": "random:seed0"})
        theirs, ours = inspect_both(path, capsys)
        assert ours == theirs
        code, info = ours
        assert code == 0 and info["layout"].startswith("reference")
        assert info["epoch"] == 7 and info["vgg_weights_provenance"] == "random:seed0"
        assert info["has_discriminator"] is True and info["generator_parameters"] > 1000

    def test_raw_state_dict(self, tmp_path, capsys):
        from terra_gan_tpu.utils.torch_compat import save_pth

        path = tmp_path / "raw.pth"
        save_pth(path, {"enc1.conv.weight": np.zeros((8, 1, 3, 3))})
        theirs, ours = inspect_both(path, capsys)
        assert ours == theirs
        assert ours[0] == 0 and ours[1]["layout"].startswith("raw state dict")
        assert ours[1]["generator_tensors"] == 1 and ours[1]["generator_parameters"] == 72

    def test_unrecognized_object(self, tmp_path, capsys):
        from terra_gan_tpu.utils.torch_compat import save_pth

        path = tmp_path / "junk.pth"
        save_pth(path, [1, 2, 3])
        theirs, ours = inspect_both(path, capsys)
        assert ours == theirs == (1, {"path": str(path), "bytes": path.stat().st_size,
                                      "layout": "unrecognized (list)"})

    def test_an_object_weights_only_refuses_is_reported(self, tmp_path, capsys):
        path = tmp_path / "pickled.pth"
        torch.save({"generator_state_dict": {}, "thing": np.dtype("float32")}, path)
        assert doctor.main(["--inspect", str(path)]) == 1
        info = json.loads(capsys.readouterr().out)
        assert info["layout"].startswith("unreadable with weights_only=True")
