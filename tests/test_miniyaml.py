"""The config parser (utils.miniyaml) reads every shipped config exactly as
PyYAML's safe_load does, and refuses YAML outside its subset."""

import glob
import os

import pytest

from rsvio_tpu.utils import miniyaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")
SHIPPED = sorted(os.path.basename(p)
                 for p in glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


def test_all_six_configs_are_covered():
    assert len(SHIPPED) == 6


@pytest.mark.parametrize("name", SHIPPED)
def test_equals_pyyaml_safe_load(name):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(CONFIG_DIR, name)) as f:
        text = f.read()
    # The reference strips the OpenCV-style directive before serde does.
    ref = yaml.safe_load("\n".join(
        ln for ln in text.splitlines()
        if not ln.strip().startswith("%YAML"))) or {}
    assert miniyaml.loads(text, name) == ref


def test_scalars_resolve_as_yaml_1_1():
    got = miniyaml.loads("a: 1.0e-6\nb: 1e4\nc: 1.0e5\nd: on\ne: Off\n"
                         "f: ~\ng: 'q'\nh: \"x y\"\ni: -3\nj: f32\nk:\n")
    assert got == {"a": 1e-6, "b": "1e4", "c": "1.0e5", "d": True,
                   "e": False, "f": None, "g": "q", "h": "x y", "i": -3,
                   "j": "f32", "k": None}


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n",                 # block sequence
    "a: {b: 1}\n",                 # flow mapping
    "a: &x 1\nb: *x\n",            # anchor / alias
    "a: |\n  text\n",              # block scalar
    "a:\n\tb: 1\n",                # tab indentation
    "a: [1, 2\n",                  # unterminated flow list
    "a: 1\na: 2\n",                # duplicate key
    "a: 0x1f\n",                   # hex number
    "a: !!str 1\n",                # tag
    "a: b: c\n",                   # inline mapping
    "x: 1\n---\ny: 2\n",           # second document
    "a:\n    b: 1\n  c: 2\n",      # inconsistent indentation
], ids=["seq", "flowmap", "anchor", "block", "tab", "unterminated", "dup",
        "hex", "tag", "inline", "docs", "indent"])
def test_unsupported_syntax_raises(text):
    with pytest.raises(ValueError, match=r"cfg\.yaml:\d+"):
        miniyaml.loads(text, "cfg.yaml")
