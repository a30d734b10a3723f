"""The port's configuration against the JAX package's: the packaged JSON
defaults equal ``yaml.safe_load`` of the JAX ``default.yaml`` (values and
types, every key, ``tpu.*`` included), and the layering rules of
``tests/unit/test_config.py`` (added keys, type changes, int to float,
None, tolerated keys) give the same outcome in both packages."""

import json
from pathlib import Path

import pytest
import yaml

import alphadia_tpu.config.config as jax_config_module
from alphadia_torch.config import config as port_config_module
from alphadia_torch.exceptions import KeyAddedConfigError, TypeMismatchConfigError
from alphadia_tpu.exceptions import KeyAddedConfigError as JaxKeyAddedConfigError
from alphadia_tpu.exceptions import TypeMismatchConfigError as JaxTypeMismatchConfigError

pytest_plugins = ("torch_port_plugin",)


def _typed(node):
    """The tree with each leaf's type beside its value (1 and 1.0 and True
    compare equal in Python, the types tell them apart)."""
    if isinstance(node, dict):
        return {k: _typed(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_typed(v) for v in node]
    return (type(node).__name__, node)


def test_json_defaults_equal_the_jax_yaml():
    yaml_tree = yaml.safe_load(Path(jax_config_module.DEFAULT_CONFIG_PATH).read_text())
    json_tree = json.loads(Path(port_config_module.DEFAULT_CONFIG_PATH).read_text())
    assert _typed(json_tree) == _typed(yaml_tree)
    assert list(json_tree) == list(yaml_tree)
    assert "tpu" in json_tree


def test_loaded_defaults_match():
    port, jax = port_config_module.load_default_config(), jax_config_module.load_default_config()
    assert {k: v for k, v in port.data.items() if k != "version"} == {k: v for k, v in jax.data.items() if k != "version"}
    assert port["version"] is not None
    assert port.get_path("fdr.fdr") == 0.01


LAYERS = {
    "added_key": {"search": {"not_a_key": 1}},
    "added_top_key": {"not_a_section": {"a": 1}},
    "str_for_int": {"search": {"target_ms2_tolerance": "ten"}},
    "dict_for_value": {"search": {"target_ms2_tolerance": {"a": 1}}},
    "value_for_dict": {"search": 3},
    "bool_for_int": {"search": {"quant_window": True}},
    "int_for_bool": {"general": {"save_figures": 1}},
    "int_to_float": {"search": {"target_ms2_tolerance": 10.5}},
    "float_to_int": {"search_initial": {"rt_tolerance": 1}},
    "none_to_str": {"library_path": "/tmp/lib.hdf"},
    "str_to_none": {"fdr": {"group_level": None}},
    "tolerated_key": {"general": {"use_gpu": True}, "tpu": {"cycle_pad": 4}},
    "tpu_key": {"tpu": {"gather_slab": 128, "compute_dtype": "float32"}},
    "list_value": {"raw_paths": ["a.npz", "b.npz"]},
}


def _outcome(module, key_err, type_err, layer):
    cfg = module.load_default_config()
    try:
        cfg.update_layer(layer, name="user")
    except key_err as e:
        return "KeyAddedConfigError", e.key
    except type_err as e:
        return "TypeMismatchConfigError", e.key
    data = {k: v for k, v in cfg.data.items() if k != "version"}
    return "ok", data, [(name, changes) for name, changes in cfg.layers]


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_rules_match_jax(case):
    ours = _outcome(port_config_module, KeyAddedConfigError, TypeMismatchConfigError, LAYERS[case])
    theirs = _outcome(jax_config_module, JaxKeyAddedConfigError, JaxTypeMismatchConfigError, LAYERS[case])
    assert ours == theirs


def test_provenance_and_set_path():
    cfg = port_config_module.load_default_config()
    cfg.update_layer({"search": {"target_ms2_tolerance": 15}}, name="user")
    cfg.update_layers([("cli", {"search": {"target_ms1_tolerance": 3}}), ("empty", {})])
    assert cfg["search"]["target_ms2_tolerance"] == 15 and cfg["search"]["target_ms1_tolerance"] == 3
    summary = cfg.modified_summary()
    assert "[user] search.target_ms2_tolerance: 10 -> 15" in summary and "[cli]" in summary
    assert [name for name, _ in cfg.layers] == ["user", "cli"]
    cfg.set_path("search.target_rt_tolerance", 100.0)
    assert cfg.get_path("search.target_rt_tolerance") == 100.0
    with pytest.raises(KeyAddedConfigError):
        cfg.set_path("search.zzz", 1)
    again = port_config_module.Config.from_json(json.dumps(cfg.data))
    assert again.data == cfg.data
