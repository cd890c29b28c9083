"""Start the ranks of a sharded run: `spawn(world, fn, *args, backend=...)`.

The counterpart of `jax.distributed.initialize` and of the launcher half of
`tools/launch_distributed.py`. `spawn` starts `world` processes with the
`spawn` start method; each initialises `torch.distributed` from a
`FileStore` in a fresh temporary directory (no port to collide on when many
test workers run at once), pins torch to one intra-op thread on the CPU,
builds its `comm.ShardGroup` and calls `fn(group, *args)`. The results come
back as numpy (tensors converted, containers kept), in rank order.

A rank that raises makes `spawn` raise with that rank's traceback, and the
other ranks are stopped; so does a run that outlasts `timeout`. Nothing is
swallowed.

`fn` travels by its import path, so it is a module-level function of a
module that imports no JAX (the port, or a test helper): a child process
never imports `jax`.

Devices. `device="cuda"` (the default) puts every rank on the card:
with NCCL rank r on `cuda:r`, which needs `world` cards; with gloo every
rank on `cuda:0` of a one-card machine (rank % count in general), and
collectives staged through host memory (`comm.py`). `device="cpu"` runs
the plain versions under gloo. No choice is made for the caller: NCCL with
more ranks than cards, NCCL on the CPU, or CUDA without a card raise, and
name what to ask for instead. Before spawning on the card, the parent loads
the kernel library (`_build.library()`), so the ranks find it built and do
not all run nvcc at once.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import torch

from .comm import BACKENDS, ShardGroup

DEFAULT_TIMEOUT_S = 600.0
_POLL_S = 0.05


def to_numpy(x):
    """Tensors -> numpy arrays, through dicts, lists, tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def check_request(world: int, backend: str, device: str) -> None:
    """Raise where the request cannot run as asked (never substitute)."""
    if world < 1:
        raise ValueError(f"world {world} < 1")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available: pass device='cpu' (with backend='gloo')")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' carries CUDA tensors only: use backend='gloo' with device='cpu'")
        if world > torch.cuda.device_count():
            raise RuntimeError(
                f"backend='nccl' needs one card per rank: {world} ranks, {torch.cuda.device_count()} card(s) "
                "(NCCL refuses two ranks on one GPU); use backend='gloo' to share a card")


def _rank_device(rank: int, backend: str, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank if backend == "nccl" else rank % torch.cuda.device_count())


def _child(rank, world, root, backend, device, timeout, fn, args):
    err_path = os.path.join(root, f"rank{rank}.err")
    try:
        torch.set_num_threads(1)
        dev = _rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = torch.distributed.FileStore(os.path.join(root, "store"), world)
        torch.distributed.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            group = ShardGroup(rank, world, dev, backend, torch.distributed.group.WORLD)
            out = to_numpy(fn(group, *args))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            torch.distributed.destroy_process_group()
        with open(os.path.join(root, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(os.path.join(root, f"rank{rank}.pkl.tmp"), os.path.join(root, f"rank{rank}.pkl"))
    except BaseException:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(world: int, fn, *args, backend: str, device: str = "cuda",
          timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(group, *args)` on `world` ranks; returns each rank's result
    as numpy, in rank order. Raises with a rank's traceback if one fails,
    or if the run outlasts `timeout` seconds."""
    check_request(world, backend, device)
    if torch.device(device).type == "cuda":
        from .. import _build

        _build.library()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="onepiece_spawn_") as root:
        procs = [ctx.Process(target=_child, args=(r, world, root, backend, device, timeout, fn, args),
                             name=f"rank{r}", daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks of {fn.__qualname__} still running after "
                                       f"{timeout:.0f} s{_tracebacks(root, world)}")
                time.sleep(_POLL_S)
        finally:
            _stop(procs)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            codes = {r: procs[r].exitcode for r in failed}
            raise RuntimeError(f"spawn: rank(s) {failed} of {fn.__qualname__} failed (exit codes {codes})"
                               f"{_tracebacks(root, world)}")
        results = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by this run's own ranks
        return results


def _tracebacks(root: str, world: int) -> str:
    out = ""
    for r in range(world):
        path = os.path.join(root, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                out += f"\n--- rank {r} ---\n{f.read()}"
    return out
