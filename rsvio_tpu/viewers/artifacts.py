"""Artifact viewer: visualization without any viewer process or SDK.

Writes plain files into a directory instead of streaming to rerun — the
degradation path for headless/production runs (the reference can only
no-op when its viewer connection drops, ref src/viewers/rerun.rs:186-190):

  <dir>/frames/<entity>_<frame:06d>.png   images with colored feature dots
  <dir>/map_points.ply                    latest 3D map (ASCII PLY, colored)
  <dir>/trajectory.txt                    x y z per line (rewritten)
  <dir>/trajectory.svg                    top-down XY path
  <dir>/poses.json                        latest pose per entity path

Same 11-method Viewer surface and the same deterministic feature colors.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .base import Viewer, get_feature_color, require_cv2


def _sanitize(path: str) -> str:
    return path.replace("/", "_").replace("\\", "_")


class ArtifactViewer(Viewer):
    def __init__(self, out_dir: str, image_every: int = 10,
                 max_images: int = 200):
        self.out_dir = out_dir
        self.image_every = max(1, image_every)
        self.max_images = max_images
        self._frame = 0
        self._n_images = 0
        self._poses = {}
        require_cv2("ArtifactViewer (--viewer-dir)")
        os.makedirs(os.path.join(out_dir, "frames"), exist_ok=True)

    def initialize(self) -> bool:
        return True

    def set_frame(self, frame_id: int, timestamp_ns: int) -> None:
        self._frame = int(frame_id)
        try:
            with open(os.path.join(self.out_dir, "poses.json"), "w") as f:
                json.dump({k: v for k, v in self._poses.items()}, f)
        except OSError:
            pass

    # ---- images ----
    def _want_image(self) -> bool:
        return (self._frame % self.image_every == 0
                and self._n_images < self.max_images)

    def _write_image(self, path: str, img: np.ndarray) -> None:
        try:
            import cv2
            fname = os.path.join(self.out_dir, "frames",
                                 f"{_sanitize(path)}_{self._frame:06d}.png")
            cv2.imwrite(fname, np.clip(img, 0, 255).astype(np.uint8))
            self._n_images += 1
        except Exception:
            pass

    def log_image_raw(self, path: str, img: np.ndarray) -> None:
        if self._want_image():
            self._write_image(path, np.asarray(img))

    def log_image_equalized(self, path: str, img: np.ndarray) -> None:
        img = np.asarray(img, dtype=np.float32)
        lo, hi = img.min(), img.max()
        self.log_image_raw(path, (img - lo) / max(hi - lo, 1e-6) * 255.0)

    def log_image_with_features(self, path: str, img: np.ndarray,
                                pts: np.ndarray) -> None:
        self.log_image_with_features_colored(
            path, img, pts, np.arange(len(pts)))

    def log_image_with_features_colored(self, path: str, img: np.ndarray,
                                        pts: np.ndarray,
                                        ids: np.ndarray) -> None:
        if not self._want_image():
            return
        try:
            import cv2
            vis = cv2.cvtColor(np.clip(np.asarray(img), 0, 255)
                               .astype(np.uint8), cv2.COLOR_GRAY2BGR)
            for (x, y), fid in zip(np.asarray(pts), np.asarray(ids)):
                r, g, b = get_feature_color(int(fid))
                cv2.circle(vis, (int(round(x)), int(round(y))), 3,
                           (int(b), int(g), int(r)), -1)
            fname = os.path.join(self.out_dir, "frames",
                                 f"{_sanitize(path)}_{self._frame:06d}.png")
            cv2.imwrite(fname, vis)
            self._n_images += 1
        except Exception:
            pass

    # ---- geometry ----
    def log_pose(self, path: str, T_W_B: np.ndarray) -> None:
        self._poses[_sanitize(path)] = np.asarray(T_W_B, dtype=float).tolist()

    def log_camera_frustum(self, path: str, T_W_C: np.ndarray,
                           intrinsics, image_size) -> None:
        self.log_pose(path, T_W_C)

    def log_points(self, path: str, pts: np.ndarray) -> None:
        self.log_points_colored(path, pts, np.arange(len(pts)))

    def log_points_colored(self, path: str, pts: np.ndarray,
                           ids: np.ndarray) -> None:
        pts = np.asarray(pts)
        keep = np.linalg.norm(pts, axis=1) < 300.0  # ref rerun.rs:298-306
        pts = pts[keep]
        ids = np.asarray(ids)[keep]
        try:
            with open(os.path.join(self.out_dir,
                                   f"{_sanitize(path)}.ply"), "w") as f:
                f.write("ply\nformat ascii 1.0\n"
                        f"element vertex {len(pts)}\n"
                        "property float x\nproperty float y\nproperty float z\n"
                        "property uchar red\nproperty uchar green\n"
                        "property uchar blue\nend_header\n")
                for p, fid in zip(pts, ids):
                    r, g, b = get_feature_color(int(fid))
                    f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
        except OSError:
            pass

    # --- feature-tracker debug surface (ref feature_tracker/src/viewer.rs:6-97)

    def log_labeled_points(self, path: str, uv: np.ndarray, labels) -> None:
        try:
            fname = os.path.join(self.out_dir,
                                 f"{_sanitize(path)}_labels.txt")
            with open(fname, "a") as f:
                # +0.5: pixel-center convention (ref log_feature_points).
                for (x, y), lab in zip(np.asarray(uv), labels):
                    f.write(f"{self._frame} {x + 0.5:.2f} {y + 0.5:.2f} "
                            f"{lab}\n")
        except OSError:
            pass

    def log_pyramid(self, path: str, pyramid) -> None:
        if not self._want_image():
            return
        for i, level in enumerate(pyramid):
            self._write_image(f"{path}_level{i}", np.asarray(level))

    def log_float_map(self, path: str, arr: np.ndarray) -> None:
        if not self._want_image():
            return
        try:
            import cv2
            a = np.asarray(arr, dtype=np.float32)
            lo, hi = float(a.min()), float(a.max())
            u8 = ((a - lo) / max(hi - lo, 1e-9) * 255.0).astype(np.uint8)
            vis = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
            fname = os.path.join(self.out_dir, "frames",
                                 f"{_sanitize(path)}_{self._frame:06d}.png")
            cv2.imwrite(fname, vis)
            self._n_images += 1
        except Exception:
            pass

    def log_trajectory(self, path: str, positions: np.ndarray) -> None:
        positions = np.asarray(positions)
        try:
            with open(os.path.join(self.out_dir, "trajectory.txt"), "w") as f:
                for p in positions:
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            self._write_traj_svg(positions)
        except OSError:
            pass

    def _write_traj_svg(self, positions: np.ndarray) -> None:
        """Top-down (x, y) polyline, auto-scaled into a 800x800 viewport."""
        if len(positions) < 2:
            return
        xy = positions[:, :2]
        lo = xy.min(axis=0)
        span = np.maximum(xy.max(axis=0) - lo, 1e-6)
        s = 760.0 / span.max()
        pts = (xy - lo) * s + 20.0
        path_d = " ".join(f"{'M' if i == 0 else 'L'}{x:.1f},{800 - y:.1f}"
                          for i, (x, y) in enumerate(pts))
        svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="800" '
               f'height="800"><rect width="800" height="800" fill="#111"/>'
               f'<path d="{path_d}" stroke="#ff8c00" stroke-width="2" '
               f'fill="none"/><circle cx="{pts[0][0]:.1f}" '
               f'cy="{800 - pts[0][1]:.1f}" r="5" fill="#0f0"/>'
               f'<circle cx="{pts[-1][0]:.1f}" cy="{800 - pts[-1][1]:.1f}" '
               f'r="5" fill="#f00"/></svg>')
        with open(os.path.join(self.out_dir, "trajectory.svg"), "w") as f:
            f.write(svg)
