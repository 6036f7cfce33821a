"""Run a function as every rank of a local process group, each rank in a
fresh interpreter, with a deadline.

    results = run_world("package.module:function", world=2, kwargs={...},
                        backend="gloo", workdir=tmp)

starts ``world`` processes (``python -m gymrl_tpu_torch.distributed.launch``),
each of which joins the group at ``tcp://127.0.0.1:<free port>`` through
``initialize_multihost`` and calls ``function(rank=r, world=world, **kwargs)``.
Each rank's return value comes back through ``torch.save`` in ``workdir``,
its output in ``workdir/rank{r}.log``. A rank that raises, or a world that
outlives ``timeout_s``, kills every rank and raises here with the ranks'
logs: no rank waits forever on a dead peer.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import time
from typing import Any

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_world(target: str, world: int, kwargs: dict | None = None, **kw) -> list[Any]:
    """``target`` (``"module:function"``) run as ranks ``0..world-1``;
    returns their return values in rank order (``start_world``'s keywords)."""
    return start_world(target, world, kwargs, **kw).wait()


class World:
    """A running world of ranks (``start_world``); ``wait`` collects it."""

    def __init__(self, target, procs, logs, workdir, deadline, timeout_s):
        self.target, self.procs, self.logs = target, procs, logs
        self.workdir, self.deadline, self.timeout_s = workdir, deadline, timeout_s

    def wait(self) -> list[Any]:
        """Block until every rank has exited; their return values in rank
        order. Raises, after killing every rank, on a failed rank or the
        deadline."""
        procs, world = self.procs, len(self.procs)
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > self.deadline:
                    failed = f"world of {world} outlived {self.timeout_s} s"
                    break
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed is None and bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed is not None:
            text = "\n".join(f"--- rank {r} ---\n{_tail(self.logs[r])}" for r in range(world))
            raise RuntimeError(f"{self.target}: {failed}\n{text}")
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def start_world(target: str, world: int, kwargs: dict | None = None, *, workdir: str,
                backend: str = "gloo", timeout_s: float = 600.0,
                extra_path: tuple[str, ...] = ()) -> World:
    """Start ``target`` as ranks ``0..world-1`` and return at once."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(kwargs or {}, os.path.join(workdir, "args.pt"))
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT, *extra_path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["OMP_NUM_THREADS"] = "1"
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gymrl_tpu_torch.distributed.launch", target, str(r),
                 str(world), addr, workdir, backend, str(timeout_s)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_ROOT))
    return World(target, procs, logs, workdir, time.monotonic() + timeout_s, timeout_s)


def _main(argv: list[str]) -> None:
    from gymrl_tpu_torch.distributed.mesh import initialize_multihost
    import torch.distributed as dist

    target, rank, world, addr, workdir, backend, timeout_s = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)  # ranks share the host's cores
    kwargs = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    initialize_multihost(addr, world, rank, backend=backend, timeout_s=float(timeout_s))
    try:
        out = fn(rank=rank, world=world, **kwargs)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    _main(sys.argv[1:])
