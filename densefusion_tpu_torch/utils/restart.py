"""Self-exec restart for the RSS guard of ``cli.train`` (counterpart of
``densefusion_tpu/utils/restart.py``).

When the process's resident memory crosses ``rss_restart_gb``, the trainer
saves and the CLI replaces the process image with ``os.execve``, so whatever
host memory leaked is returned to the OS.

The subtlety this module owns: when the CLI was launched as ``python -m
densefusion_tpu_torch.cli.train``, ``sys.argv[0]`` is the module's *file
path*; re-exec'ing that path as a script puts ``.../densefusion_tpu_torch/
cli`` (not the repository root) at ``sys.path[0]``, and the restarted
process dies with ``ModuleNotFoundError: densefusion_tpu_torch`` unless the
shell happened to export ``PYTHONPATH=<repo root>``. So the package's parent
directory goes into the child's ``PYTHONPATH`` explicitly.
"""

from __future__ import annotations

import os
import sys


def restart_env(base_env=None) -> dict:
    """Environment for the re-exec'd child: the inherited environment with
    the package's parent directory prepended to ``PYTHONPATH`` (existing
    entries kept, none repeated)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if base_env is None else base_env)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if pkg_root not in parts:
        parts.insert(0, pkg_root)
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


def reexec_self(argv: list[str]) -> None:
    """Replace this process with ``python argv`` (``sys.argv``-shaped,
    ``argv[0]`` the script path), keeping imports working. Never returns."""
    os.execve(sys.executable, [sys.executable] + list(argv), restart_env())
