"""The port's YAML reader and typed config against PyYAML and the JAX package's config.

``utils.yaml_lite`` must give what ``yaml.safe_load`` gives on the
project's configs and on every construct of its subset, and raise with
the line number on what is outside it; the port's ``Config`` must equal
the JAX package's field for field on the same inputs, unknown-key
warnings included.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from pathlib import Path

import pytest
import yaml

from terra_gan_tpu.config import Config as JConfig
from terra_gan_tpu_torch.config import Config, LoopConfig, load_config
from terra_gan_tpu_torch.utils import yaml_lite

EXAMPLE = Path(__file__).resolve().parents[1] / "config.example.yaml"
LOGGER = "terra_gan_tpu_torch.config"

# the workspace config of tests/test_cli_pipeline.py, as that test writes it
CLI_WORKSPACE = {
    "training": {
        "loss_weights": {"perceptual": 0.0, "tv": 0.1, "boundary": 0},
        "modes": {
            "initial": {"epochs": 1, "batch_size": 2},
            "human_guided": {
                "epochs": 1, "batch_size": 2, "learning_rate": 1e-4,
                "human_feedback_weight": 0.3, "base_loss_weight": 0.7,
            },
        },
    },
    "evaluation": {"checkpoint_dir": "ckpts"},
    "mask_processing": {"visualization": {"enabled": False}},
    "experiment_tracking": {"enabled": False},
    "data": {
        "raw_dir": "data/raw", "processed_dir": "data/processed",
        "output_dir": "data/output", "input_zip_folder": "data/zips",
        "models_dir": "data/models", "image_size": 64,
    },
}

SNIPPETS = [
    "a: 1", "a: 2e-4", "a: 2.0e-4", "a: 1.", "a: .5", "a: -.inf", "a: .NaN", "a: 0x1F",
    "a: 0o7", "a: 017", "a: 08", "a: 0b101", "a: 1_000", "a: 1:30", "a: 1:30.5", "a: +12",
    "a: -0", "a: 6.02e23", "a: 1e3", "a: 1.0e+3", "a: yes", "a: No", "a: ON", "a: off",
    "a: y", "a: True", "a: FALSE", "a: ~", "a: null", "a: Null", "a:", "a: # a comment",
    "a: 'x # y'", 'a: "x # y"', "a: x#y", "a: x #y", "a: 'it''s'", 'a: "t\\tab\\u00e9\\x41"',
    'a: ""', "a: ''", "a: http://x.y/z", "a: -5", "a: -x", "a: :x", "a: foo bar",
    "a:  spaced  ", "a: [enc1, dec1]", "a: []", "a: [1, 'two', 3.0, null, true]",
    "a: [a, ]", "a: [a, 'b, c'] # c", "a:\n- x\n- y\nb: 2", "a:\n  - x\n  - y",
    "a:\n  b:\n    c: 1\n  d: 2", "- a\n- b", "-\n- a", "- a: 1\n  b: 2\n- c: 3",
    "- - a\n  - b\n- c", "a: b\n\n# c\n\n   # indented comment\nd: e", "---\na: 1",
    "1: a\ntrue: b\n~: c", "'k: x': 1", '"q": 2', "a:\n  b", "", "# only a comment", "x",
    "a: 1\na: 2", "buildings:          # reference stub\nroads: 3", "a:\n  -\n    b: 1",
]

OUTSIDE = [  # (text, the line the error names)
    ("a: &x 1", 1), ("a: 1\nb: *x", 2), ("a: !!str 1", 1), ("a: |\n  x", 1), ("a: >\n  x", 1),
    ("a: {b: 1}", 1), ("a: b\n  c", 2), ("a: 'x\n  y'", 1), ("? a\n: b", 1),
    ("<<: {}", 1), ("a: 2001-12-14", 1), ("a: =", 1), ("%YAML 1.1\na: 1", 1),
    ("a: 1\n---\nb: 2", 2), ("a: 1\n...", 2), ("a: [b, [c]]", 1), ("a: [b,\n  c]", 1),
    ("a: b: c", 1), ("\ta: 1", 1), ("a:\n\t- b", 2), ("a: [b: c]", 1), ("a: [,b]", 1),
    ("a: [b,,c]", 1), ("a: - b", 1), ("a:\n  b: 1\n c: 2", 3), ("- a\nb: 1", 2),
    ('a: "\\q"', 1), ("a: @x", 1), ("a: `x`", 1), ("a: 1\n  b: 2", 2), ("[a, b]: 1", 1),
]


def same(a, b) -> bool:
    """Equal values of equal types (bool is not int here), NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_yaml_lite_reads_the_example_config_as_safe_load_does():
    text = EXAMPLE.read_text()
    assert same(yaml_lite.loads(text), yaml.safe_load(text))
    assert same(yaml_lite.load(EXAMPLE), yaml.safe_load(text))


def test_yaml_lite_reads_the_cli_workspace_config_as_safe_load_does():
    text = yaml.safe_dump(CLI_WORKSPACE)
    assert same(yaml_lite.loads(text), yaml.safe_load(text))
    assert yaml_lite.loads(text) == CLI_WORKSPACE  # safe_dump sorts the keys


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_lite_equals_safe_load_on_the_subset(text):
    assert same(yaml_lite.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,line", OUTSIDE)
def test_yaml_lite_raises_with_the_line_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"yaml_lite: line {line}: "):
        yaml_lite.loads(text)


def dict_inputs():
    example = yaml.safe_load(EXAMPLE.read_text())
    extra = {
        "training": {"remat_stages": ["enc1", "dec1"], "faithful_boundary_default": False,
                     "loss_weights": {"boundary": 0.25}, "feed_workers": 3,
                     "qat_tail": {"steps": 5}},
        "evaluation": {"quant": "w8a8", "metrics": {"boundary_size": 4}},
        "data": {"parent_structure": {"output": ["inpainted", "colored"]}},
        "experiment_tracking": {"tags": {"k": "v"}},
    }
    return [example, CLI_WORKSPACE, extra, {}]


def shared(cfg: Config) -> dict:
    """The port's config as a dict without its own ``model`` section (at its
    default here: none of these inputs sets it), which the JAX package lacks."""
    d = dataclasses.asdict(cfg)
    assert d.pop("model") == {"generator": "pconv_unet"}
    return d


@pytest.mark.parametrize("index", range(4), ids=["example", "cli_workspace", "extra", "empty"])
def test_config_from_dict_equals_the_jax_config(index):
    d = dict_inputs()[index]
    assert shared(Config.from_dict(d)) == dataclasses.asdict(JConfig.from_dict(d))


def test_config_load_equals_the_jax_load(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(CLI_WORKSPACE))
    for p in (EXAMPLE, path):
        assert shared(load_config(p)) == dataclasses.asdict(JConfig.load(p))


def test_config_rejects_an_unknown_quant_mode():
    with pytest.raises(ValueError, match="evaluation.quant"):
        Config.from_dict({"evaluation": {"quant": "int4"}})


def test_loop_config_derives_from_the_training_section():
    cfg = Config.from_dict(dict_inputs()[2])
    loop = LoopConfig.from_training(cfg.training)
    assert loop.boundary == 0.25  # faithful_boundary_default: false makes the yaml value real
    cfg = Config.from_dict(CLI_WORKSPACE)
    loop = LoopConfig.from_training(cfg.training)
    assert (loop.epochs, loop.batch_size, loop.perceptual, loop.tv, loop.boundary) == (
        1, 2, 0.0, 0.1, 0.5)
    assert loop.loss_config().boundary_weight == 0.5


class TestUnknownKeyWarnings:
    def test_typo_warns_with_suggestion(self, caplog):
        with caplog.at_level(logging.WARNING, LOGGER):
            Config.from_dict({"training": {"remat_stage": ["enc1"]}})
        assert any(
            "training.remat_stage" in r.message and "remat_stages" in r.message
            for r in caplog.records
        )

    def test_nested_typo_warns(self, caplog):
        with caplog.at_level(logging.WARNING, LOGGER):
            Config.from_dict({
                "training": {"modes": {"initial": {"epoch": 3}}},
                "evaluation": {"metrics": {"iou_treshold": 0.4}},
            })
        msgs = [r.message for r in caplog.records]
        assert any("training.modes.initial.epoch" in m for m in msgs)
        assert any("evaluation.metrics.iou_treshold" in m for m in msgs)

    def test_known_extras_do_not_warn(self, caplog):
        with caplog.at_level(logging.WARNING, LOGGER):
            Config.from_dict({
                "training": {
                    "vgg_weights_path": "vgg.npz",
                    "compute_dtype": "bf16",
                    "remat_stages": ["enc1"],
                    "async_checkpoint": True,
                    "vgg_remat": False,
                },
                "evaluation": {"quant": "w8a8"},
            })
        assert not caplog.records

    def test_freeform_sections_not_checked(self, caplog):
        with caplog.at_level(logging.WARNING, LOGGER):
            Config.from_dict({
                "mask_processing": {"my_custom_detector": {"knob": 1}},
                "data": {"some_future_key": "x"},
            })
        assert not caplog.records

    def test_the_example_config_loads_warning_free(self, caplog):
        with caplog.at_level(logging.WARNING, LOGGER):
            cfg = load_config(EXAMPLE)
        assert not caplog.records
        assert cfg.training.initial.batch_size == 32
