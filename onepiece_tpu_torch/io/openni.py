"""Live RGB-D capture interface with a sensor-rate replay backend.

Port of `onepiece_tpu/io/openni.py`. The reference captures from an Asus
Xtion through OpenNI2; no capture hardware is attached here, but what
the live loop programs against is the reader's contract: frames arrive on
the sensor's clock, and a blocking `get_next_rgbd` returns the due frame,
or None when the stream ends. `ReplayRGBDReader` keeps that contract by
replaying a TUM-format directory at a chosen rate, so a live-loop driver
(`tools/torch_acquire_live_data.py`) runs end to end; a real sensor
backend implements the same three methods.
"""

from __future__ import annotations

import time

from .tum import TumSequence


class LiveRGBDReader:
    """The interface of the reference's OpenNIReader (Init / GetNextRGBD)."""

    def init(self) -> bool:
        raise NotImplementedError(
            "live capture needs an OpenNI2 sensor; replay a recorded TUM folder with ReplayRGBDReader instead")

    def get_next_rgbd(self):
        raise NotImplementedError

    def close(self) -> None:
        pass


class ReplayRGBDReader(LiveRGBDReader):
    """A TUM-format directory replayed as a live stream.

    `get_next_rgbd()` blocks until the next frame is due on the replay clock
    (frame i at i / rate_hz seconds after `init`), then returns (timestamp,
    rgb (H, W, 3) uint8, depth (H, W) float32 metres); None when the
    sequence ends."""

    def __init__(self, root: str, rate_hz: float = 30.0, max_frames: int | None = None):
        self.root = root
        self.rate_hz = rate_hz
        self.max_frames = max_frames
        self._seq = None
        self._i = 0
        self._t0 = 0.0

    def init(self) -> bool:
        self._seq = TumSequence(self.root, max_frames=self.max_frames)
        self._i = 0
        self._t0 = time.monotonic()
        return len(self._seq) > 0

    def get_next_rgbd(self):
        if self._seq is None or self._i >= len(self._seq):
            return None
        delay = self._t0 + self._i / self.rate_hz - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        frame = self._seq[self._i]
        self._i += 1
        return frame

    def close(self) -> None:
        self._seq = None
