"""Process-group-safe subprocess execution.

The LaTeX toolchain (latexmk) spawns children that outlive a plain
``Popen.kill()``. Like reference ``util/subprocess.py:8-48``, every command
runs in its own session/process group and on timeout the *whole group* gets
SIGKILL, so no zombie ``pdflatex`` survives an MCTS rollout timeout.
"""
from __future__ import annotations

import os
import signal
import subprocess
from typing import Sequence


def safe_killpg(pid: int, sig: int = signal.SIGKILL) -> None:
    try:
        os.killpg(os.getpgid(pid), sig)
    except (ProcessLookupError, PermissionError):
        pass


def run(cmd: Sequence[str], *, timeout: float | None = None,
        cwd: str | None = None, env: dict | None = None,
        input_bytes: bytes | None = None) -> subprocess.CompletedProcess:
    """Run ``cmd`` in a fresh process group; SIGKILL the group on timeout.

    Never raises on nonzero exit (callers inspect ``returncode``); raises
    ``subprocess.TimeoutExpired`` after killing the group on timeout.
    """
    proc = subprocess.Popen(
        list(cmd), cwd=cwd, env=env,
        stdin=subprocess.PIPE if input_bytes is not None else subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(input=input_bytes, timeout=timeout)
    except subprocess.TimeoutExpired:
        safe_killpg(proc.pid)
        proc.wait()
        raise
    except BaseException:
        safe_killpg(proc.pid)
        proc.wait()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def check_output(cmd: Sequence[str], **kw) -> bytes:
    result = run(cmd, **kw)
    if result.returncode != 0:
        raise subprocess.CalledProcessError(
            result.returncode, cmd, result.stdout, result.stderr)
    return result.stdout
