"""The collectives of the sharded modules over `torch.distributed`.

The JAX package runs `parallel/` as `shard_map` bodies over a device `Mesh`
with a named axis; here each shard is a process (a rank), the body of a
`shard_map` is the rank's own code, and the four collectives it uses are
calls on a `ShardGroup`:

  psum        `jax.lax.psum`: `all_reduce` SUM
  all_gather  `jax.lax.all_gather`: stacked on a new leading axis, rank order
  ring_shift  `jax.lax.ppermute` with the permutation [(i, (i + 1) % n)]:
              rank r sends to r + 1 and receives from r - 1
              (`batch_isend_irecv`)
  all_to_all  `jax.lax.all_to_all(split_axis=0, concat_axis=0)`: row d of the
              (world, ...) send buffer goes to rank d; row s of the result
              came from rank s (`all_to_all_single`)

NCCL takes the CUDA tensors as they are. gloo carries CPU tensors only (it
takes CUDA tensors for few collectives): a CUDA tensor in a gloo group is
copied to the host, exchanged, and copied back, explicitly, and the bytes so
staged are counted. That is how ranks that share one card (NCCL refuses two
ranks on one GPU) run every collective. A world of 1 works with either
backend.

Each group counts, per collective, its calls, the bytes this rank put in
(its send buffer), the bytes staged through the host (both directions) and
the time the calls took (CUDA events on a CUDA device, the host clock on
the CPU); `stats()` reads them.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
COLLECTIVES = ("psum", "all_gather", "ring_shift", "all_to_all")


@dataclasses.dataclass
class _Count:
    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    host_ms: float = 0.0
    events: list = dataclasses.field(default_factory=list)  # (start, end) CUDA events


@dataclasses.dataclass
class ShardGroup:
    """One rank's view of the process group: its rank, the world size, the
    device its tensors live on, the backend and the `ProcessGroup`."""

    rank: int
    world: int
    device: torch.device
    backend: str
    pg: dist.ProcessGroup | None = None
    counts: dict = dataclasses.field(default_factory=lambda: {c: _Count() for c in COLLECTIVES})

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: expected one of {BACKENDS}")
        self.device = torch.device(self.device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend carries CUDA tensors only: use backend='gloo' on the CPU")

    @property
    def staged(self) -> bool:
        """Collectives go through host copies (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- bookkeeping ------------------------------------------------------

    def _begin(self, name: str, sent: torch.Tensor):
        c = self.counts[name]
        c.calls += 1
        c.bytes += sent.numel() * sent.element_size()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return c, start
        return c, time.perf_counter()

    def _end(self, c: _Count, start) -> None:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            c.events.append((start, end))
        else:
            c.host_ms += (time.perf_counter() - start) * 1e3

    def _to_wire(self, c: _Count, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend carries: a host copy under gloo (counted),
        a contiguous tensor otherwise."""
        t = t.contiguous()
        if self.staged:
            c.staged_bytes += t.numel() * t.element_size()
            return t.to("cpu")
        return t

    def _from_wire(self, c: _Count, t: torch.Tensor) -> torch.Tensor:
        if self.staged:
            c.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def reset_stats(self) -> None:
        self.counts = {name: _Count() for name in COLLECTIVES}

    def stats(self) -> dict:
        """{collective: {calls, bytes, staged_bytes, ms}} since the last
        reset; on a CUDA device it waits for the recorded events."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for name, c in self.counts.items():
            ms = c.host_ms + sum(s.elapsed_time(e) for s, e in c.events)
            out[name] = dict(calls=c.calls, bytes=c.bytes, staged_bytes=c.staged_bytes, ms=ms)
        return out

    def subgroup(self, world: int) -> "ShardGroup | None":
        """The group of ranks 0..world-1 (every rank of this group must call
        it, in the same order: `new_group` is collective); None on the ranks
        outside. Its ranks keep their numbers."""
        if not 1 <= world <= self.world:
            raise ValueError(f"subgroup of {world} ranks in a group of {self.world}")
        pg = dist.new_group(list(range(world)), backend=self.backend)
        return ShardGroup(self.rank, world, self.device, self.backend, pg) if self.rank < world else None

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of the rows of `x` (N, ...), after
        padding with zeros to a multiple of the world size (`shard_map`'s
        split of a sharded axis)."""
        n = x.shape[0]
        per = -(-n // self.world)
        pad = per * self.world - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        return x[self.rank * per : (self.rank + 1) * per]

    # -- the collectives --------------------------------------------------

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, on every rank (a new tensor)."""
        c, start = self._begin("psum", t)
        w = self._to_wire(c, t)
        w = w.clone() if w is t else w  # all_reduce works in place; the caller's tensor stays
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.pg)
        out = self._from_wire(c, w)
        self._end(c, start)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` in rank order. Every rank
        passes the same shape and dtype."""
        c, start = self._begin("all_gather", t)
        w = self._to_wire(c, t)
        parts = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(parts, w, group=self.pg)
        out = self._from_wire(c, torch.stack(parts))
        self._end(c, start)
        return out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Rank r sends `t` to rank (r + 1) % world and returns what rank
        (r - 1) % world sent. Every rank passes the same shape and dtype."""
        c, start = self._begin("ring_shift", t)
        w = self._to_wire(c, t)
        if self.world == 1:
            recv = w.clone()
        else:
            recv = torch.empty_like(w)
            ops = [dist.P2POp(dist.isend, w, (self.rank + 1) % self.world, group=self.pg),
                   dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.world, group=self.pg)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = self._from_wire(c, recv)
        self._end(c, start)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (world, ...): row d goes to rank d; returns (world, ...) whose
        row s came from rank s. Every rank passes the same shape."""
        if t.shape[0] != self.world:
            raise ValueError(f"all_to_all: leading axis {t.shape[0]}, expected the world size {self.world}")
        c, start = self._begin("all_to_all", t)
        w = self._to_wire(c, t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.pg)
        out = self._from_wire(c, out)
        self._end(c, start)
        return out
