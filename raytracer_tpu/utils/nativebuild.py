"""Build the repository's native libraries from source at first use.

Libraries go to `<checkout>/build/` (listed in .gitignore), named by a
digest of their inputs and compile command, so an edited source builds a
new file and never loads a stale one. A build writes a temporary file and
renames it into place under a file lock, so concurrent processes (test
workers) neither race nor load a half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_DIR = os.path.join(CHECKOUT, "native")
BUILD_DIR = os.path.join(CHECKOUT, "build")


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str, sources: list[str], command: list[str],
                  inputs: list[str] = ()) -> str:
    """Compile `sources` with `command + ["-o", out] + sources` and return
    the library's path. `inputs` lists further files (headers) whose
    contents select the build."""
    digest = hashlib.sha256(repr(command).encode())
    for path in list(sources) + list(inputs):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(command + ["-o", tmp] + list(sources),
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"{name}: compiler not found: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{name}: build failed ({' '.join(command)}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out
