"""Prefetching RGB-D sequence loader: a ring of decoder processes.

Port of `onepiece_tpu/io/native_loader.py` and the ring half of
`onepiece_tpu/native/rgbd_loader.cpp` (`:104-130`): workers decode frame
N + k while the consumer runs frame N, each frame into ring slot
`N % ring`, and a worker starts a frame only once the consumer has freed
that slot. Frames come out in listing order, whichever worker finishes
first.

The workers are processes (`io/tum_frames.py` run as a script), not
threads: the PNG row-filter sweep is many small numpy calls that hold the
interpreter lock, so decoder threads slow each other and the consumer's
launch thread (`tools/compare_torch_ring.py` times both). A worker imports
numpy and `png.py` only, never torch, and is started with its own
interpreter, so nothing of the parent's CUDA context or thread pools is
forked. Frame i goes to worker i % n_threads; the decoded floats land in
shared memory (a memfd of `ring` slots) and the consumer copies them out
before it frees the slot.

There is no fallback decoder. A file that fails to read or decode makes
the consumer raise at its frame, naming the file; a worker that dies makes
it raise at that worker's next frame. `close()`, the end of the iteration,
an early `break` and garbage collection all stop every worker.

    for depth_m, gray in PrefetchingRGBDLoader(pairs, depth_scale=5000.0):
        slam.process_frame(gray, depth_m)
"""

from __future__ import annotations

import builtins
import contextlib
import json
import mmap
import os
import subprocess
import sys
import weakref

import numpy as np

from . import png

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tum_frames.py")
STOP_TIMEOUT_S = 10.0
# Defaults: 4 decoder processes and 16 slots (two chunks of 8 frames ahead),
# where the JAX loader takes 2 threads and 4 slots. On the card's 8-core
# host 2 processes do not feed the fused loop (`tools/compare_torch_ring.py`:
# 96 frames at 640x480, the loop fed by 2 / 4 slots 46.3 ms/frame, by 4 / 16
# 27.5, by 6 / 12 29.5, preloaded 17.3).
N_WORKERS = 4
RING = 16


def _stop(procs: list[subprocess.Popen], mem: mmap.mmap, fd: int) -> None:
    """Stop every worker, then free the ring's memory."""
    for p in procs:
        for pipe in (p.stdin, p.stdout):
            with contextlib.suppress(OSError):
                pipe.close()
        if p.poll() is None:
            p.kill()
        p.wait(STOP_TIMEOUT_S)
    mem.close()
    os.close(fd)


class PrefetchingRGBDLoader:
    """Iterate (depth_meters float32 (H, W), gray float32 (H, W) in [0, 1],
    or rgb float32 (H, W, 3) in [0, 1]) frames of `pairs`, a list of
    (depth_png_path, rgb_png_path). `n_threads` decoder processes, `ring`
    frames decoded ahead at most. One pass: the loader stops its workers when
    the pass ends."""

    def __init__(self, pairs: list[tuple[str, str]], depth_scale: float = 5000.0, gray: bool = True,
                 n_threads: int = N_WORKERS, ring: int = RING):
        if n_threads < 1 or ring < 1:
            raise ValueError(f"n_threads ({n_threads}) and ring ({ring}) must be at least 1")
        self.pairs = [(str(d), str(c)) for d, c in pairs]
        self.depth_scale = float(depth_scale)
        self.gray = gray
        self.ring = ring
        self._begun = False
        self.workers: list[subprocess.Popen] = []
        if not self.pairs:
            self._finalizer = None
            return
        with open(self.pairs[0][0], "rb") as f:
            head = f.read(33)
        try:
            self.width, self.height = png.image_size(head)
        except ValueError as e:
            raise ValueError(f"{self.pairs[0][0]}: {e}") from None
        self._shape = (self.height, self.width) if gray else (self.height, self.width, 3)
        self._n_depth = self.height * self.width
        self._slot_floats = self._n_depth + int(np.prod(self._shape))
        fd = os.memfd_create("onepiece-tum-ring", os.MFD_CLOEXEC)
        os.ftruncate(fd, ring * self._slot_floats * 4)
        self._mem = mmap.mmap(fd, ring * self._slot_floats * 4)
        argv = [sys.executable, "-P", WORKER, str(fd), str(self.height), str(self.width), repr(self.depth_scale),
                "gray" if gray else "rgb"]
        self._finalizer = weakref.finalize(self, _stop, self.workers, self._mem, fd)
        for _ in range(min(n_threads, len(self.pairs))):
            self.workers.append(subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                                 pass_fds=(fd,)))
        for i in range(min(ring, len(self.pairs))):
            self._issue(i)

    def __len__(self) -> int:
        return len(self.pairs)

    def _worker(self, i: int) -> subprocess.Popen:
        return self.workers[i % len(self.workers)]

    def _issue(self, i: int) -> None:
        """Give frame i (its slot is free) to its worker."""
        job = json.dumps([i, i % self.ring, *self.pairs[i]]) + "\n"
        with contextlib.suppress(BrokenPipeError):  # a dead worker: reading its answer raises at frame i
            p = self._worker(i)
            p.stdin.write(job.encode())
            p.stdin.flush()

    def _take(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Wait for frame i, copy it out of its slot and free the slot."""
        p = self._worker(i)
        line = p.stdout.readline()
        if not line:
            try:
                code = p.wait(STOP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                code = "none, still running"
            raise RuntimeError(f"decoder process {p.pid} closed its output (exit code {code}) before frame {i} "
                               f"({self.pairs[i][0]}, {self.pairs[i][1]})")
        answer = json.loads(line)
        if answer[0] != i:
            raise RuntimeError(f"decoder process {p.pid} answered frame {answer[0]}, expected {i}")
        if answer[1] is not None:
            kind = getattr(builtins, answer[1], None)
            if not (isinstance(kind, type) and issubclass(kind, Exception)):
                kind = RuntimeError
            raise kind(f"frame {i}: {answer[2]}")
        at = (i % self.ring) * self._slot_floats * 4
        depth = np.frombuffer(self._mem, np.float32, self._n_depth, at).reshape(self.height, self.width).copy()
        img = np.frombuffer(self._mem, np.float32, self._slot_floats - self._n_depth,
                            at + self._n_depth * 4).reshape(self._shape).copy()
        if i + self.ring < len(self.pairs):
            self._issue(i + self.ring)
        return depth, img

    def __iter__(self):
        if self._begun:
            raise RuntimeError("PrefetchingRGBDLoader makes one pass; this one has begun")
        self._begun = True
        try:
            for i in range(len(self.pairs)):
                yield self._take(i)
        finally:
            self.close()

    def close(self) -> None:
        """Stop every worker and free the ring (idempotent)."""
        if self._finalizer is not None:
            self._finalizer()
