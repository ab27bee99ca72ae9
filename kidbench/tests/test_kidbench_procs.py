"""A run leaves no process behind: the resource tracker that
``multiprocessing``'s spawn starts is stopped, and every other process
the run started, orphaned descendants too, has ended and been waited for
before the command prints."""
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from kidbench import drive, procs

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, multiprocessing, subprocess, sys
from kidbench import procs
procs.adopt_orphans()
kids = procs.Children()
lock = multiprocessing.get_context("spawn").Lock()      # starts the tracker
tracker = procs._tracker()._pid
quick = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(0.3)"])
straggler = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
parent = subprocess.Popen(
    [sys.executable, "-c",
     "import subprocess, sys; p = subprocess.Popen([sys.executable, '-c', "
     "'import time; time.sleep(120)']); print(p.pid, flush=True)"],
    stdout=subprocess.PIPE, text=True)
orphan = int(parent.stdout.readline())
parent.wait()
ended = kids.stop(grace=1.0)
print(json.dumps(dict(ended=ended, tracker=tracker, straggler=straggler.pid,
                      orphan=orphan, left=sorted(procs.children()),
                      tracker_now=procs._tracker()._pid)))
"""


def _exists(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_stop_ends_the_tracker_stragglers_and_orphans():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["left"] == [] and r["tracker_now"] is None
    assert [c.split()[0] for c in r["ended"]] == sorted(
        str(p) for p in (r["straggler"], r["orphan"]))
    for pid in (r["tracker"], r["straggler"], r["orphan"]):
        assert not _exists(pid)


def test_the_sharded_command_leaves_no_child(monkeypatch, capsys):
    """The command, past its look for cards, runs the sharded loop on
    gloo ranks (their spawn starts the tracker, the reference its
    workers): once it has printed, this process has no child it did not
    have before, and the checks are still the last lines."""
    from kidbench import run
    from kidbench.sharded import sharded_case_loop
    from test_kidbench_faults import SEED, small_sharded

    def run_cell(cell, seed, seconds, trace, dev, t_start, control=False):
        r = drive.Run(small_sharded(), SEED, 0.3, False, torch.device("cpu"),
                      t_start, control=False, workers=2)
        return sharded_case_loop(r)

    before = procs.children()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "cpu")
    monkeypatch.setattr(run, "set_caches", lambda: None)
    monkeypatch.setattr(drive, "run_cell", run_cell)
    rc = run.main(["--workload", "cumulus2d_weak4.loop", "--seed",
                   str(SEED), "--seconds", "0.3"])
    captured = capsys.readouterr()
    left = procs.children() - before
    assert rc == 0, captured.err
    assert left == set(), [procs._command(p) for p in left]
    assert json.loads(captured.out.splitlines()[-1])["correct"]
    assert captured.err.splitlines()[-1].startswith("check ")
