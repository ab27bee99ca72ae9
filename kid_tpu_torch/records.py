"""The port's records: JSON files that its measuring scripts write at the
repository root (``SCALING_h100.json``, ``VALIDATION_h100.json``,
``MULTIPROC_h100.json``, ``BENCH_h100.json``), the counterparts of the
reference's ``*_r05.json``.

Each file says where it ran: ``hardware`` (every card's name and power
limit as ``nvidia-smi`` gives them, torch, CUDA and NCCL versions, the
host), ``commit`` (the checkout's git commit, or ``KID_TPU_TORCH_COMMIT``
where the checkout has no ``.git``) and ``source_sha256`` (a digest of the
port's sources, so a record can be matched to a tree without git).  A
file that several scripts write, block by block, keeps the blocks already
in it (``merge``); ``runs`` then says, for each block, where it ran.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
COMMIT_ENV = "KID_TPU_TORCH_COMMIT"


def card_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card, one
    line each; [] where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def hardware(device) -> dict:
    """What ran a measurement on ``device`` (a ``torch.device``)."""
    hw = {"device": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
          "cards": card_lines() if device.type == "cuda" else [],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host": platform.machine(), "host_cpus": os.cpu_count()}
    if device.type == "cuda":
        hw["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    return hw


def commit() -> str | None:
    """The checkout's commit: ``git rev-parse HEAD`` where it has a
    ``.git``, else ``KID_TPU_TORCH_COMMIT`` if set, else None."""
    try:
        return subprocess.run(
            ["git", "-C", str(PKG.parent), "rev-parse", "HEAD"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return os.environ.get(COMMIT_ENV)


def source_sha256() -> str:
    """SHA-256 of the port's sources (every ``.py``, ``.cu`` and ``.cuh``
    of the package, by relative path, in order)."""
    h = hashlib.sha256()
    for p in sorted(PKG.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh") and "__pycache__" not in p.parts:
            h.update(p.relative_to(PKG).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def provenance(device) -> dict:
    """``hardware``, ``commit``, ``source_sha256``, the command line and
    the UTC time."""
    return {"hardware": hardware(device), "commit": commit(),
            "source_sha256": source_sha256(),
            "argv": [Path(sys.argv[0]).name, *sys.argv[1:]],
            "at": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds")}


def read(path) -> dict:
    """The JSON record at ``path``; {} if there is none."""
    path = Path(path)
    return json.loads(path.read_text()) if path.exists() else {}


def write(path, report: dict, device) -> dict:
    """``report`` with its provenance, written to ``path`` whole."""
    report = {**report, **provenance(device)}
    _dump(path, report)
    return report


def merge(path, blocks: dict, device) -> dict:
    """``blocks`` merged into the JSON record at ``path`` (made if there
    is none): blocks of other names stay as they are, blocks of these
    names are replaced, and ``runs[name]`` holds each one's provenance;
    the top-level provenance is that of the last writer.  Returns the
    record."""
    report = read(path)
    prov = provenance(device)
    report.update(blocks)
    report.update(prov)
    report.setdefault("runs", {}).update(dict.fromkeys(blocks, prov))
    _dump(path, report)
    return report


def _dump(path, report: dict):
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(report, indent=1) + "\n")
    tmp.replace(path)
