"""The CLI path needs only the packages every machine that runs it has:
with cv2 and yaml unimportable, the EuRoC entry point, the scene generator
and chip_smoke.py import and every shipped config loads. chip_smoke.py
refuses to run without a GPU."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = """
import glob, os, sys
sys.modules["cv2"] = None      # import cv2 / import yaml now raise
sys.modules["yaml"] = None
sys.path.insert(0, os.getcwd())
import rsvio_tpu.cli.run_euroc
import rsvio_tpu.data.synthetic
import chip_smoke
from rsvio_tpu.utils.config import load_config, load_yaml_stripped
for path in sorted(glob.glob("config/*.yaml")):
    if os.path.basename(path) == "tartanair.yaml":
        load_yaml_stripped(path)        # the mono tracker's own schema
    else:
        load_config(path)
print("loaded", len(glob.glob("config/*.yaml")))
"""


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_path_imports_without_cv2_and_yaml():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("loaded 6")


def test_chip_smoke_fails_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    lines = r.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = {}
        assert last.get("ok") is not True


def test_image_viewers_fail_clearly_without_cv2(tmp_path, monkeypatch):
    import pytest

    from rsvio_tpu.viewers.artifacts import ArtifactViewer

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"ArtifactViewer.*OpenCV \(cv2\)"):
        ArtifactViewer(str(tmp_path / "viz"))
