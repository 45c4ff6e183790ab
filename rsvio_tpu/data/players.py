"""Dataset players: manifest parsing + image loading for EuRoC, TUM-VI and
4Seasons, with an async double-buffered prefetcher feeding the device.

Capability parity (SURVEY.md §2 #7-9):
  * EuRoC / TUM-VI: timestamps from `mav0/cam0/data.csv` (skip header/#
    lines, `ts,filename` rows), grayscale PNGs under `mav0/cam{0,1}/data/`
    (ref src/datasets/euroc_player.rs:178-237)
  * 4Seasons: `times.txt` whitespace-split manifest, filename `<ts>.png`,
    images under `undistorted_images/cam{0,1}/`
    (ref src/datasets/fourseasons_player.rs:179-216)
  * real-time pacing and step mode live in the player loop (cli/run.py)

Design: the reference decodes PNGs synchronously inside the frame loop (its
I/O hot spot, SURVEY.md §3.1); here a background thread decodes and stages
frames ahead of the device so host I/O overlaps device compute.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .png import read_png


@dataclass
class FrameData:
    """One stereo frame (host memory)."""
    timestamp_ns: int
    left: np.ndarray   # (H, W) float32
    right: np.ndarray  # (H, W) float32


@dataclass
class ImuSample:
    """IMU record (ref src/datasets/mod.rs:21-26)."""
    timestamp_ns: int
    gyro: np.ndarray   # (3,)
    accel: np.ndarray  # (3,)


def _load_gray(path: str) -> np.ndarray:
    """Grayscale frame as float32 on the 8-bit intensity scale, converted as
    the native loader does: a 16-bit image keeps its high byte and RGB(A)
    takes the integer BT.601 luma."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = img >> 8
    img = img.astype(np.int32)
    if img.ndim == 3:
        img = (299 * img[..., 0] + 587 * img[..., 1]
               + 114 * img[..., 2]) // 1000
    return img.astype(np.float32)


class EurocPlayer:
    """EuRoC MAV dataset layout (also the TUM-VI mav0 export layout)."""

    cam0_dir = "mav0/cam0"
    cam1_dir = "mav0/cam1"
    imu_dir = "mav0/imu0"

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        self.entries = self._load_manifest()

    def _load_manifest(self) -> List[Tuple[int, str]]:
        """(ref euroc_player.rs:178-210: skip header and # lines)."""
        path = os.path.join(self.root, self.cam0_dir, "data.csv")
        entries = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#") or not row[0].strip().isdigit():
                    continue
                entries.append((int(row[0]), row[1].strip()))
        entries.sort()
        return entries

    def __len__(self):
        return len(self.entries)

    def frame_paths(self, i: int) -> Tuple[int, str, str]:
        ts, fname = self.entries[i]
        return (ts,
                os.path.join(self.root, self.cam0_dir, "data", fname),
                os.path.join(self.root, self.cam1_dir, "data", fname))

    def load_frame(self, i: int) -> FrameData:
        ts, lp, rp = self.frame_paths(i)
        return FrameData(ts, _load_gray(lp), _load_gray(rp))

    def load_imu(self) -> List[ImuSample]:
        """IMU csv: ts, gx, gy, gz, ax, ay, az (EuRoC layout). The reference
        has this disabled (`if false`, ref euroc_player.rs:283) — here it
        feeds the VIO preintegration path."""
        path = os.path.join(self.root, self.imu_dir, "data.csv")
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#") or not row[0].strip().isdigit():
                    continue
                vals = [float(v) for v in row[1:7]]
                out.append(ImuSample(int(row[0]),
                                     np.asarray(vals[:3]), np.asarray(vals[3:])))
        return out

    def ground_truth_file(self) -> Optional[str]:
        p = os.path.join(self.root, "mav0", "state_groundtruth_estimate0", "data.csv")
        return p if os.path.exists(p) else None


class TUMVIPlayer(EurocPlayer):
    """TUM-VI uses the same mav0 layout (ref tum_vi_player.rs is a near-clone
    of euroc_player.rs)."""


class FourSeasonsPlayer:
    """4Seasons: times.txt manifest, undistorted_images/cam{0,1}/<ts>.png
    (ref fourseasons_player.rs:179-216)."""

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        self.entries = self._load_manifest()

    def _load_manifest(self) -> List[Tuple[int, str]]:
        path = os.path.join(self.root, "times.txt")
        entries = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                ts = int(parts[0])
                entries.append((ts, f"{parts[0]}.png"))
        entries.sort()
        return entries

    def __len__(self):
        return len(self.entries)

    def frame_paths(self, i: int) -> Tuple[int, str, str]:
        ts, fname = self.entries[i]
        return (ts,
                os.path.join(self.root, "undistorted_images", "cam0", fname),
                os.path.join(self.root, "undistorted_images", "cam1", fname))

    def load_frame(self, i: int) -> FrameData:
        ts, lp, rp = self.frame_paths(i)
        return FrameData(ts, _load_gray(lp), _load_gray(rp))

    def load_imu(self) -> List[ImuSample]:
        return []

    def ground_truth_file(self) -> Optional[str]:
        p = os.path.join(self.root, "GNSSPoses.txt")
        return p if os.path.exists(p) else None


def prefetch_frames(player, start: int = 0, end: Optional[int] = None,
                    depth: int = 4) -> Iterator[FrameData]:
    """Background-thread prefetching iterator: PNG decode overlaps device
    compute (replaces the reference's synchronous in-loop decode)."""
    end = len(player) if end is None else min(end, len(player))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def worker():
        try:
            for i in range(start, end):
                q.put(player.load_frame(i))
        except Exception as e:  # surface decode errors to the consumer
            q.put(e)
        q.put(SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is SENTINEL:
            break
        if isinstance(item, Exception):
            raise item
        yield item


class TartanAirPlayer:
    """TartanAir mono sequences: image_left/*.png ordered by filename
    (capability of the reference's experimental crate,
    ref feature_tracker/src/players/tartanair_player.rs:24-62, which reads
    image_left, caps at 800 frames and feeds the mono tracker)."""

    MAX_FRAMES = 800

    def __init__(self, dataset_path: str):
        self.root = dataset_path
        img_dir = os.path.join(dataset_path, "image_left")
        names = sorted(n for n in os.listdir(img_dir)
                       if n.endswith(".png"))[: self.MAX_FRAMES]
        self.entries = [(i, n) for i, n in enumerate(names)]

    def __len__(self):
        return len(self.entries)

    def load_frame(self, i: int) -> FrameData:
        idx, name = self.entries[i]
        img = _load_gray(os.path.join(self.root, "image_left", name))
        # mono: right slot mirrors left (consumers use left only)
        return FrameData(int(idx * 1e8), img, img)
