"""Parity of the port's config loader with the JAX package's.

Each of the port's YAML copies parses (with the port's own reader) to what
``yaml.safe_load`` gives for the JAX file; override tokens parse exactly as
``instageo_tpu.configs.config.parse_overrides`` parses them; the port's
writer round-trips through its reader and through ``yaml.safe_load``.
All comparisons are exact (==).
"""

import math
import os

import pytest
import yaml

from instageo_tpu.configs import config as jax_config
from instageo_tpu_torch.configs import config as cfgmod
from instageo_tpu_torch.train.factory import TPU_KEYS, check_tpu_config

PORT_CONFIGS = ("config", "sen1floods11", "multitemporal_crop_classification",
                "multitemporal_crop_t4", "locust")
JAX_DIR = os.path.dirname(os.path.abspath(jax_config.__file__))


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_port_config_equals_jax_yaml(name):
    with open(os.path.join(JAX_DIR, name + ".yaml")) as f:
        ref = yaml.safe_load(f)
    ours = cfgmod.load_config(name)
    assert ours.to_dict() == ref  # exact
    assert ours == jax_config.load_config(name)
    # The JAX config's tpu section passes the port's table.
    check_tpu_config(ours)


TOKENS = [
    "train.learning_rate=1e-4", "train.learning_rate=1.0e-4", "x=1.0e4", "x=0.0001",
    "x=0755", "x=0x1f", "x=0b101", "x=1:30", "x=1_000", "x=+1", "x=-1", "x=.5", "x=0.",
    "x=09", "x=-.inf", "x=yes", "x=on", "x=Off", "x=True", "x=false", "x=~", "x=null",
    "x=", "x=None", "x=2024-01-01", "dataloader.bands=[0,1,2,3,4,5]", "x=[a, b,]",
    "x=[1, [2, 3], {a: 1}]", "x={use: True, p: 0.5}", "x='quoted'", "x=\"a\\tb\"",
    "x='it''s'", "x=a #comment", "x=a#b", "x=[1,2", "x=a: b", "+new.key=3",
    "run_dir=/tmp/some dir/run", "mode=train", "x=--", "x=*", "x=prithvi_eo_v1_100",
]


def test_overrides_parse_as_jax():
    for tok in TOKENS:
        ours = cfgmod.parse_overrides([tok])
        ref = jax_config.parse_overrides([tok])
        assert ours == ref or (
            isinstance(ref[0].get("x"), float) and math.isnan(ref[0]["x"])), tok
    argvs = [["--config-name=locust", "mode=eval"], ["--config-name", "locust", "a.b=2"],
             ["--config-path", "/p", "--config-name=n"]]
    for argv in argvs:
        assert cfgmod.parse_overrides(argv) == jax_config.parse_overrides(argv)
    for bad in (["--train.batch_size=128"], ["--config-name"]):
        with pytest.raises(ValueError):
            cfgmod.parse_overrides(bad)
        with pytest.raises(ValueError):
            jax_config.parse_overrides(bad)


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_to_yaml_round_trips(name, tmp_path):
    cfg = cfgmod.load_config(name, overrides={
        "extra.floats": [1e-5, 2.5e10, float("inf"), -0.0, 3.0], "extra.text": "a: b #c",
        "extra.words": ["null", "True", "1", "", "it's", "- x"], "extra.empty": {},
        "extra.nested": [{"a": [1, 2]}, []]})
    path = cfgmod.save_config(cfg, str(tmp_path))
    with open(path) as f:
        text = f.read()
    assert cfgmod.loads(text) == cfg.to_dict()
    assert yaml.safe_load(text) == cfg.to_dict()
    assert cfgmod.load_config("config.yaml", os.path.dirname(path)) == cfg


def test_augmentations_and_required_flags_match_jax():
    for name in PORT_CONFIGS:
        assert (cfgmod.get_augmentations(cfgmod.load_config(name))
                == jax_config.get_augmentations(jax_config.load_config(name)))
    cfg = cfgmod.load_config("locust", overrides={"root_dir": "/r"})
    cfgmod.check_required_flags(["root_dir"], cfg)
    with pytest.raises(ValueError):
        cfgmod.check_required_flags(["root_dir", "train_filepath"], cfg)
    merged = cfgmod.merge(cfg, {"train": {"batch_size": 3}})
    ref = jax_config.merge(jax_config.load_config("locust", overrides={"root_dir": "/r"}),
                           {"train": {"batch_size": 3}})
    assert merged == ref and cfg.train.batch_size == 8


def test_tpu_table_refuses_what_is_not_ported():
    for key, rule in TPU_KEYS.items():
        if rule[0] == "refused":
            with pytest.raises(NotImplementedError, match="ROADMAP item"):
                check_tpu_config({"tpu": {key: "not-a-default"}})
    with pytest.raises(ValueError):
        check_tpu_config({"tpu": {"precision": "fp8"}})
    check_tpu_config({"tpu": {"steps_per_call": "auto", "attn_impl": "pallas",
                              "dropout_impl": "bits8", "unknown_key": 3}})
