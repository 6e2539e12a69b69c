"""Start the ranks of a mesh run on one host.

``spawn(target, world, args)`` runs ``target`` (``"module:function"``, a
function of a module that imports neither JAX nor anything that does) in
``world`` fresh processes on the CPU, one rank each, joined over gloo by
a ``FileStore`` in a temporary directory.  Each rank calls ``function(*args)``
after the process group is up, so a ``make_mesh()`` inside it spans the
world.  Returns the ranks' return values in rank order (they travel
pickled).  A rank that raises fails the call with its traceback; a call
that outlives ``timeout`` seconds (a hung collective) is killed and
raises ``TimeoutError``.  Every process it starts has ended when it
returns or raises.

From the shell, the same run is ``torchrun --nproc_per_node N script.py``
where the script calls ``run_simulation(backend="mesh", ...)``: the port
makes the process group from torchrun's environment (NCCL with one card
a rank, or gloo with ``device="cpu"``).
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(target, rank, world, store, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        import torch
        import torch.distributed as dist
        # the ranks share the host's cores
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, _resolve(target)(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:   # noqa: BLE001 (the parent re-raises it)
        results.put((rank, False, traceback.format_exc()))


def spawn(target: str, world: int, args=(), timeout: float = 300.0):
    """Run ``target(*args)`` on ``world`` ranks; see the module
    docstring."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fedml_mesh_")
    store = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store, tuple(args),
                               results), daemon=True)
             for r in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{target} on {world} ranks ran past {timeout:.0f} s "
                    f"(ranks {sorted(set(range(world)) - set(out))} never "
                    "returned)")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {target} died with exit code "
                        f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {target} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
