"""The port's YAML subset reader (``config/yaml_subset.load``) against
``yaml.safe_load``, on the CPU:

- the JAX package's ``config/default.yaml``, the ``frozen_config.yaml``
  that the port's ``SearchStep`` writes, and the YAML snippets of
  ``docs/config.md`` and ``docs/quickstart.md`` read to what PyYAML reads;
- scalars: YAML 1.1 booleans, nulls, octal / hex / binary / ``_`` ints,
  floats only with a dot (``1e5`` stays text), ``.inf``, ``.nan``,
  quoted scalars and comments;
- a hypothesis round trip: any nested config of str / int / float / bool /
  None the emitter writes reads back to itself and to what PyYAML reads;
- anything outside the subset raises ``ConfigError`` naming its line.
"""

import math
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from alphadia_torch.config import load_default_config
from alphadia_torch.config.yaml_subset import dump, load
from alphadia_torch.exceptions import ConfigError

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]


def same(a, b) -> bool:
    """Equal values and types (NaN equals NaN, key order counts)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def _doc_snippets():
    out = []
    for name in ("config.md", "quickstart.md"):
        text = (REPO / "docs" / name).read_text()
        out += [(f"{name}[{i}]", s) for i, s in enumerate(re.findall(r"```yaml\n(.*?)```", text, re.S))]
    assert len(out) >= 2
    return out


@pytest.mark.parametrize("name,text", [("default.yaml", (REPO / "alphadia_tpu/config/default.yaml").read_text()),
                                       *_doc_snippets()], ids=lambda v: v if isinstance(v, str) and len(v) < 40 else "")
def test_reads_what_pyyaml_reads(name, text):
    assert same(load(text), yaml.safe_load(text)), name


def test_reads_the_frozen_config_the_port_writes(tmp_path):
    cfg = load_default_config()
    cfg.update_layer({"raw_paths": ["a b.mzML", "yes", "1e5"], "general": {"random_state": 7}, "fdr": {"fdr": 0.05}})
    cfg.to_yaml(tmp_path / "frozen_config.yaml")
    text = (tmp_path / "frozen_config.yaml").read_text()
    assert same(load(text), yaml.safe_load(text))
    assert same(load(text), cfg.data)


SCALARS = """\
b: [yes, No, TRUE, off, On, y, n]
n: [~, null, Null, NULL]
i: [0, -7, +12, 1_000, 0x1F, 017, 0b101, 007]
f: [1.5, -0.25, 1., .5, 1.0e+5, 1.0e-05, 1e5, 1.0e5, .inf, -.Inf, +.INF, .nan, 1_0.5]
s: ["a\\tb\\u00e9", 'it''s', 'x # y', plain words, a-b/c.d, 12ab, "", '']
empty_key:
nested:
  - [1, 'two', "three"]
  - key: 1   # a comment
    other: [x]
  -
    - 1
    - - 2
top_list_at_key_indent:
- 1
- 2
'quoted key': 1
"double": 2
3: int key
true: bool key
"""


def test_scalars_resolve_as_in_pyyaml():
    assert same(load(SCALARS), yaml.safe_load(SCALARS))
    got = load(SCALARS)
    assert got["f"][6] == "1e5" and got["b"][5] == "y" and got["i"][5] == 15


OUTSIDE = {
    "anchor": "a: &x 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  text\n",
    "folded_scalar": "a: >\n  text\n",
    "flow_mapping": "a: {b: 1}\n",
    "nested_flow": "a: [[1, 2]]\n",
    "timestamp": "a: 2024-01-01\n",
    "sexagesimal": "a: 1:30\n",
    "multi_line_plain": "a: b\n  c\n",
    "unclosed_quote": "a: 'b\n",
    "document_marker": "---\na: 1\n",
    "tab_indent": "a:\n\tb: 1\n",
    "merge_key": "a:\n  <<: 1\n",
    "complex_key": "? a\n: 1\n",
    "bad_escape": 'a: "\\x41"\n',
}


@pytest.mark.parametrize("case", OUTSIDE)
def test_outside_the_subset_raises_with_the_line(case):
    text = "ok: 1\n" + OUTSIDE[case]
    with pytest.raises(ConfigError, match=r"YAML line [23]\b"):
        load(text)


_KEYS = st.text(st.characters(codec="utf-8", categories=("L", "N", "P", "S", "Zs")), min_size=1, max_size=8)
_SCALARS = (
    st.none()
    | st.booleans()
    | st.integers(-(2**70), 2**70)
    | st.floats(allow_nan=True, allow_infinity=True)
    | st.text(st.characters(codec="utf-8", categories=("L", "N", "P", "S", "Z", "Cc", "Cf")), max_size=12)
)
_TREES = st.recursive(
    _SCALARS, lambda kids: st.lists(kids, max_size=4) | st.dictionaries(_KEYS, kids, max_size=4), max_leaves=20
)


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(_KEYS, _TREES, max_size=6))
def test_emitter_round_trip(data):
    text = dump(data)
    assert same(load(text), data)
    assert same(load(text), yaml.safe_load(text))
