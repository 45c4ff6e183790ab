"""Cross-device parity checks (rsvio_tpu.parity). On the CPU they run CPU
against CPU at small sizes, which must agree exactly; the `gpu` tests run
the card against the CPU at the EuRoC widths, as chip_smoke.py's parity
phase does."""

import os
import sys

import jax
import numpy as np
import pytest

from rsvio_tpu import parity
from rsvio_tpu.ops.klt import KLTConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, H=96, W=128, seed=0):
    from rsvio_tpu.data import synthetic as syn
    scene = syn.scene_depth_structured(H, W, seed=seed)
    traj = syn.traj_6dof()
    return [tuple(np.float32(np.rint(im)))
            for im in (syn.render_stereo(scene, traj.pose(k / 20), k / 20)
                       for k in range(n))]


class TestOnCpu:
    def test_tracker_parity_is_exact_on_one_device(self):
        cpu = jax.devices("cpu")[0]
        d = parity.tracker_parity(cpu, cpu, _frames(2, H=160, W=224),
                                  KLTConfig(levels=3, max_iterations=10),
                                  n=16)
        assert d["ok"], d
        assert d["cam0_mask_flips"] == 0 and d["cam0_pos_px"] == 0.0

    def test_solve_ba_parity_is_exact_on_one_device(self):
        cpu = jax.devices("cpu")[0]
        d = parity.solve_ba_parity(cpu, cpu, n_kf=4, n_lm=32)
        assert d["ok"] and d["pose"] == 0.0, d

    def test_solve_vio_ba_parity_is_exact_on_one_device(self):
        cpu = jax.devices("cpu")[0]
        d = parity.solve_vio_ba_parity(cpu, cpu, n_kf=4, n_lm=32)
        assert d["ok"] and d["pose"] == 0.0, d


@pytest.fixture()
def euroc(tmp_path):
    """The smoke's synthetic sequence and config, at full EuRoC width."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from rsvio_tpu.utils.config import load_config, make_estimator_config

    seq = chip_smoke.make_sequence(1, parity.VO_FRAMES)
    path = str(tmp_path / "euroc_synthetic.yaml")
    chip_smoke.write_config(path)
    ecfg, rig = make_estimator_config(load_config(path))
    frames = [(np.float32(l), np.float32(r)) for l, r in seq["frames"]]
    return frames, ecfg, rig


@pytest.mark.gpu
class TestGpuAgainstCpu:
    @pytest.fixture(autouse=True)
    def _full_precision(self):
        """As every entry point runs: float32 matmuls, no TF32."""
        with jax.default_matmul_precision("highest"):
            yield

    def test_tracker(self, euroc):
        frames, ecfg, _ = euroc
        d = parity.tracker_parity(jax.devices()[0], jax.devices("cpu")[0],
                                  frames[:2], ecfg.frontend.klt,
                                  n=ecfg.frontend.capacity)
        assert d["ok"], d

    def test_solve_ba(self):
        d = parity.solve_ba_parity(jax.devices()[0], jax.devices("cpu")[0])
        assert d["ok"], d

    def test_solve_vio_ba(self):
        d = parity.solve_vio_ba_parity(jax.devices()[0],
                                       jax.devices("cpu")[0])
        assert d["ok"], d

    def test_vo_frames(self, euroc):
        frames, ecfg, rig = euroc
        d = parity.vo_parity(jax.devices()[0], jax.devices("cpu")[0],
                             frames, ecfg, rig)
        assert d["ok"], d
