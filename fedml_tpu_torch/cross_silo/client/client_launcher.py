"""Silo process launcher (reference ``cross_silo/client/client_launcher.py``
— torchrun-style spawn of the silo's worker processes; and the 3-process
pattern of ``python/tests/cross-silo/run_cross_silo.sh``).

Spawns each participant as a real OS process running a user entry script
with rank/role passed by environment (``FEDML_TPU_RANK`` / ``FEDML_TPU_ROLE``
/ ``FEDML_TPU_RUN_ID``), which is how multi-host deployments launch too —
the entry script calls ``fedml_tpu.init()`` and the comm backend (filestore /
gRPC / MQTT) rendezvouses by run_id.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


class CrossSiloLauncher:
    """Launch a federation (1 server + N clients) as local processes."""

    def __init__(self, entry_script: str, run_id: str,
                 client_ranks: Sequence[int],
                 extra_env: Optional[Dict[str, str]] = None,
                 python: str = sys.executable):
        self.entry_script = entry_script
        self.run_id = str(run_id)
        self.client_ranks = list(client_ranks)
        self.extra_env = dict(extra_env or {})
        self.python = python
        self.procs: List[subprocess.Popen] = []

    def _spawn(self, rank: int, role: str) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.extra_env)
        # children must resolve the same imports as the launcher (the
        # launcher may run from a source tree that isn't pip-installed);
        # merged AFTER extra_env so a caller-supplied PYTHONPATH adds to,
        # not replaces, the sys.path injection
        env["PYTHONPATH"] = os.pathsep.join(
            [p or os.getcwd() for p in sys.path]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env["FEDML_TPU_RANK"] = str(rank)
        env["FEDML_TPU_ROLE"] = role
        env["FEDML_TPU_RUN_ID"] = self.run_id
        proc = subprocess.Popen([self.python, self.entry_script],
                                env=env)
        log.info("launched %s rank=%d pid=%d", role, rank, proc.pid)
        return proc

    def launch(self) -> None:
        self.procs = [self._spawn(0, "server")] + [
            self._spawn(r, "client") for r in self.client_ranks]

    def wait(self, timeout_s: float = 600.0) -> List[int]:
        """Join all processes; kills the survivors if any participant fails
        or the deadline passes. Returns exit codes in launch order."""
        deadline = time.time() + timeout_s
        codes: List[Optional[int]] = [None] * len(self.procs)
        try:
            while time.time() < deadline:
                pending = False
                for i, p in enumerate(self.procs):
                    if codes[i] is None:
                        codes[i] = p.poll()
                        if codes[i] is None:
                            pending = True
                        elif codes[i] != 0:
                            raise RuntimeError(
                                f"participant {i} exited with {codes[i]}")
                if not pending:
                    return [int(c) for c in codes]
                time.sleep(0.2)
            raise TimeoutError(f"federation did not finish in {timeout_s}s")
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)  # reap: no zombies, no ResourceWarning
            except Exception:
                pass

    def run(self, timeout_s: float = 600.0) -> List[int]:
        self.launch()
        return self.wait(timeout_s)


def env_rank() -> int:
    return int(os.environ.get("FEDML_TPU_RANK", "0"))


def env_role() -> str:
    return os.environ.get("FEDML_TPU_ROLE", "server")


def env_run_id(default: str = "0") -> str:
    return os.environ.get("FEDML_TPU_RUN_ID", default)
