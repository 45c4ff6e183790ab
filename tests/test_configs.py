"""The shipped config/*.yaml files must load through the config system and
produce well-formed estimator configs (parity with the reference's
config/euroc_vio.yaml, tum_vi.yaml, 4seasons.yaml + the experimental crate's
feature_tracker/config/config.yaml)."""

import os

import numpy as np
import pytest

from rsvio_tpu.utils.config import load_config, make_estimator_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "config")


@pytest.mark.parametrize("name,width,height,model", [
    ("euroc_vio.yaml", 752, 480, "pinhole-radtan"),
    ("tum_vi.yaml", 512, 512, "EUCM"),
    ("4seasons.yaml", 800, 400, "pinhole-radtan"),
])
def test_dataset_config_loads(name, width, height, model):
    cfg = load_config(os.path.join(CONFIG_DIR, name))
    assert cfg.camera.image_width == width
    assert cfg.camera.image_height == height
    assert cfg.camera.left_model == model
    # Extrinsics are valid rigid transforms (orthonormal rotation block).
    for T in (cfg.camera.T_B_Cl_matrix(), cfg.camera.T_B_Cr_matrix()):
        R = T[:3, :3]
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert np.allclose(T[3], [0, 0, 0, 1])
    ecfg, rig = make_estimator_config(cfg)
    assert ecfg.window_size == 10
    assert ecfg.image_shape == (height, width)


def test_euroc_stereo_baseline_sane():
    cfg = load_config(os.path.join(CONFIG_DIR, "euroc_vio.yaml"))
    T_Cl_Cr = (np.linalg.inv(cfg.camera.T_B_Cl_matrix())
               @ cfg.camera.T_B_Cr_matrix())
    baseline = np.linalg.norm(T_Cl_Cr[:3, 3])
    assert 0.09 < baseline < 0.13  # EuRoC rig ~11 cm


def test_tartanair_tracker_config_loads():
    from rsvio_tpu.cli.run_tartanair import _load_tracker_yaml
    y = _load_tracker_yaml(os.path.join(CONFIG_DIR, "tartanair.yaml"))
    assert y["nlevels"] == 5
    assert y["ratio"] == 2.0
    assert y["optical_flow_lm_lambda"] == pytest.approx(0.1)


def test_surfaced_knobs_reach_estimator_config(tmp_path):
    """Every YAML-surfaced knob must land on the estimator/tracker configs
    (regression guard against dataclass fields that parse but go nowhere)."""
    p = tmp_path / "cfg.yaml"
    p.write_text("""
camera:
  image_width: 160
  image_height: 120
  left_intrinsics: [100, 100, 80, 60]
  left_distortion: [0, 0, 0, 0]
  right_intrinsics: [100, 100, 80, 60]
  right_distortion: [0, 0, 0, 0]
keyframe_management:
  keyframe_window_size: 5
  track_before_full: false
tracker:
  track_rotation: true
  lm_lambda: 0.25
solver:
  marginalization: true
  cull_reproj_threshold: 0.1
""")
    cfg = load_config(str(p))
    ecfg, _ = make_estimator_config(cfg)
    assert ecfg.window_size == 5
    assert ecfg.track_before_full is False
    assert ecfg.use_marginalization is True
    assert ecfg.cull_reproj_threshold == pytest.approx(0.1)
    assert ecfg.frontend.klt.track_rotation is True
    assert ecfg.frontend.klt.lm_lambda == pytest.approx(0.25)


def test_round3_knobs_reach_estimator_config(tmp_path):
    """Round-3 surfaced knobs: bicubic sampling, chi^2 gate, adaptive
    detection floor."""
    p = tmp_path / "cfg.yaml"
    p.write_text("""%YAML:1.0
camera:
  image_width: 160
  image_height: 120
  left_intrinsics: [100, 100, 80, 60]
  left_distortion: [0, 0, 0, 0]
  right_intrinsics: [100, 100, 80, 60]
  right_distortion: [0, 0, 0, 0]
tracker:
  interpolation: bicubic
  feature_capacity: 128
  relax_floor_below: 40
  relaxed_min_score: 2.5
solver:
  chi2_gate: 0.015
  chi2_gate_iter: 2
  pnp_motion_prior: 15.0
  min_lm_span: 3
  bias_gyro_weight: 5e3
  bias_accel_weight: 1e4
""")
    cfg = load_config(str(p))
    ecfg, _ = make_estimator_config(cfg)
    assert ecfg.frontend.klt.interpolation == "bicubic"
    assert ecfg.frontend.relax_floor_below == 40
    assert ecfg.frontend.relaxed_min_score == pytest.approx(2.5)
    assert ecfg.ba.chi2_gate == pytest.approx(0.015)
    assert ecfg.ba.chi2_gate_iter == 2
    assert ecfg.pnp.chi2_gate == pytest.approx(0.015)
    assert ecfg.pnp.motion_prior_weight == pytest.approx(15.0)
    assert ecfg.ba.min_lm_span == 3
    # The VIO bias random-walk stiffness rides solver: -> cli VIOBAConfig
    # (the occlusion-desert defense knob — docs/NOTES.md round 5).
    assert cfg.solver.bias_gyro_weight == pytest.approx(5e3)
    assert cfg.solver.bias_accel_weight == pytest.approx(1e4)


def test_relax_floor_auto_default(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("""%YAML:1.0
camera:
  image_width: 160
  image_height: 120
  left_intrinsics: [100, 100, 80, 60]
  left_distortion: [0, 0, 0, 0]
  right_intrinsics: [100, 100, 80, 60]
  right_distortion: [0, 0, 0, 0]
tracker:
  feature_capacity: 200
""")
    cfg = load_config(str(p))
    ecfg, _ = make_estimator_config(cfg)
    # -1 (auto) resolves to capacity // 2
    assert ecfg.frontend.relax_floor_below == 100


def test_shipped_yamls_carry_matrix_defenses():
    """VERDICT r3 item 7: the shipped dataset YAMLs must carry the SAME
    defenses the committed accuracy-matrix numbers were measured with
    (chi2 gate at ~6 px gross-outlier scale in normalized units, starvation
    relax floor auto-engaged) — not just the matrix harness
    (utils/evaluation.py). Also pins the round-4 default: constant-velocity
    PnP seeding stays OFF (reference init semantics) unless opted into."""
    for name, fx in [("euroc_vio.yaml", 458.654),
                     ("tum_vi.yaml", 191.75556798912652),
                     ("4seasons.yaml", 501.475791931)]:
        cfg = load_config(os.path.join(CONFIG_DIR, name))
        ecfg, _ = make_estimator_config(cfg)
        px = ecfg.pnp.chi2_gate * fx
        assert 5.0 <= px <= 7.0, f"{name}: chi2 gate {px:.2f} px"
        assert ecfg.ba.chi2_gate == ecfg.pnp.chi2_gate
        # Starvation mode auto-engages at capacity // 2 (TrackerConfig
        # relax_floor_below default -1 = auto).
        assert ecfg.frontend.relax_floor_below == ecfg.frontend.capacity // 2
        # CV seeding is opt-in (round-3 regression 7320b34).
        assert not ecfg.pnp_cv_predict
        # Score-weighted observations ship ON (round-4 matrix evidence).
        assert ecfg.use_obs_weights


def test_pnp_cv_predict_yaml_roundtrip(tmp_path):
    p = tmp_path / "cv.yaml"
    p.write_text("""
solver:
  pnp_cv_predict: true
""")
    cfg = load_config(str(p))
    ecfg, _ = make_estimator_config(cfg)
    assert ecfg.pnp_cv_predict


def test_coarse_level_policy_yaml_roundtrip(tmp_path):
    """Round-4 knob: tracker.coarse_level_policy reaches the KLT config
    (tolerant default; the dynamic profile ships strict)."""
    p = tmp_path / "pol.yaml"
    p.write_text("""
tracker:
  coarse_level_policy: strict
""")
    cfg = load_config(str(p))
    ecfg, _ = make_estimator_config(cfg)
    assert ecfg.frontend.klt.coarse_level_policy == "strict"
    # Defaults are tolerant...
    ecfg_d, _ = make_estimator_config(load_config(
        os.path.join(CONFIG_DIR, "euroc_vio.yaml")))
    assert ecfg_d.frontend.klt.coarse_level_policy == "tolerant"
    # ...except the dynamic profile, which pins strict (occluder defense).
    ecfg_dyn, _ = make_estimator_config(load_config(
        os.path.join(CONFIG_DIR, "euroc_vo_dynamic.yaml")))
    assert ecfg_dyn.frontend.klt.coarse_level_policy == "strict"


def test_dynamic_flow_center_resolution_and_validation(tmp_path):
    """Round-5 (advisor): "auto" resolves at the single construction point
    by estimator kind (VO centers, VIO raw); on/off (incl. YAML booleans)
    pin the value; anything else is rejected at load."""
    import pytest

    p = tmp_path / "auto.yaml"
    p.write_text("solver:\n  dynamic_flow: 0.02\n")
    cfg = load_config(str(p))
    assert make_estimator_config(cfg, kind="vo")[0].dynamic_flow_center
    assert not make_estimator_config(cfg, kind="vio")[0].dynamic_flow_center

    p_on = tmp_path / "on.yaml"
    p_on.write_text("solver:\n  dynamic_flow_center: on\n")  # YAML bool True
    assert make_estimator_config(
        load_config(str(p_on)), kind="vio")[0].dynamic_flow_center

    p_off = tmp_path / "off.yaml"
    p_off.write_text('solver:\n  dynamic_flow_center: "off"\n')
    assert not make_estimator_config(
        load_config(str(p_off)), kind="vo")[0].dynamic_flow_center

    p_bad = tmp_path / "bad.yaml"
    p_bad.write_text('solver:\n  dynamic_flow_center: "of"\n')  # typo
    with pytest.raises(ValueError):
        load_config(str(p_bad))


def test_adaptive_profile_yaml():
    """Round-5 profile: euroc_vo_adaptive.yaml wires the consensus gate +
    adaptive prior + adaptive vision weighting coherently (the stage
    builder validates knob coherence)."""
    cfg = load_config(os.path.join(CONFIG_DIR, "euroc_vo_adaptive.yaml"))
    ecfg, _ = make_estimator_config(cfg)
    assert ecfg.pnp_prior_adaptive and ecfg.vision_weight_adaptive
    assert ecfg.pnp.ransac_hypotheses == 16
    assert ecfg.pnp.motion_prior_weight == 20.0
    assert ecfg.use_obs_weights
    from rsvio_tpu.models.estimator import _build_stages
    _build_stages(ecfg)  # must not raise
