"""Append-only performance ledger, the port's copy of
``modelcompression_tpu/utils/perf_ledger.py`` (standard library only;
importing the JAX module would import JAX through its package).

Each line is one JSON object stamped with the wall-clock time, the git
commit (``+dirty`` when tracked files have uncommitted changes) and the
card it was measured on: its name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, since a
card set below its maximum power runs slower under load.

The default path is ``chiprun_out/perf_ledger.jsonl`` under the
repository root (an ignored output directory), not the root
``PERF_LEDGER.jsonl``, which is the record of accepted changes and is
written by other tooling: ``append`` refuses that file.

The ledger is diagnostic, never load-bearing: a failed write (no git, a
read-only file system) is a warning on stderr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, "chiprun_out", "perf_ledger.jsonl")
_RECORD_OF_CHANGES = os.path.join(_REPO_ROOT, "PERF_LEDGER.jsonl")


def git_commit(repo_root: str = _REPO_ROOT) -> str:
    """Current short commit hash, with ``+dirty`` when the tree has
    uncommitted tracked changes; ``"unknown"`` when git is unavailable."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo_root,
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=repo_root, capture_output=True, text=True, timeout=10,
            check=True,
        ).stdout.strip()
        return sha + ("+dirty" if dirty else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_tag() -> str:
    """The card's ``name, power limit`` from nvidia-smi (the first card),
    or ``"unknown"`` where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0].strip() if out else "unknown"


def _is_record_of_changes(path: str) -> bool:
    return os.path.realpath(path) == os.path.realpath(_RECORD_OF_CHANGES)


def append(record: dict, path: str = DEFAULT_PATH) -> dict:
    """Stamp ``record`` with ``ts`` (UTC ISO), ``commit`` and ``device``
    (``device_tag()``) and append it as one JSON line.
    Returns the stamped record. Raises ``ValueError`` for the repository
    root's ``PERF_LEDGER.jsonl``; a failed write only warns."""
    if _is_record_of_changes(path):
        raise ValueError(f"{path} is the repository's record of accepted "
                         "changes; write measurements elsewhere (default "
                         f"{DEFAULT_PATH})")
    folder = os.path.dirname(os.path.abspath(path))
    try:
        os.makedirs(folder, exist_ok=True)
    except OSError as e:
        print(f"[warn] perf ledger folder: {e}", file=sys.stderr)
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "commit": git_commit(folder),
        "device": device_tag(),
        **record,
    }
    try:
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as e:
        print(f"[warn] perf ledger append failed: {e}", file=sys.stderr)
    return entry


def read(path: str = DEFAULT_PATH) -> list:
    """All ledger entries (oldest first); [] when absent or unreadable.
    Malformed lines are skipped: an interrupted append must not poison
    every later read."""
    entries = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    except OSError:
        pass
    return entries
