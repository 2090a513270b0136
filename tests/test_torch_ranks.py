"""Launching the ranks of a multi-process test, and the launcher's own
tests.

`run_ranks` starts one Python process per rank on a script (a test file
run as a program: its `__main__` entry is the rank's worker, which imports
no JAX), gives the ranks a free localhost port for their process group,
and waits for all of them under one deadline. When a rank fails or the
deadline passes it kills the others and raises with every rank's output,
so that a rank stuck in a collective never hangs the suite. This module
imports no JAX: the card tests use it too.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(extra=None):
    """The environment of a rank: the repository on the path, one intra-op
    thread (the suite runs several workers), CPU JAX where a parent set it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def start_ranks(script, args, world, env=None):
    """Start `python script <rank> <world> <port> *args` for every rank;
    returns the processes (see wait_ranks). Each rank writes to a temporary
    file (a pipe nobody reads until the end would block a rank that prints
    much)."""
    port = str(free_port())
    procs = []
    for r in range(world):
        log = tempfile.TemporaryFile("w+")
        procs.append(subprocess.Popen(
            [sys.executable, script, str(r), str(world), port, *map(str, args)],
            env=rank_env(env), cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True))
        procs[-1].log = log
    return procs


def run_ranks(script, args, world, timeout, env=None):
    """Run every rank (start_ranks) and wait for them (wait_ranks)."""
    return wait_ranks(start_ranks(script, args, world, env=env), timeout)


def wait_ranks(procs, timeout):
    """Wait for the ranks' processes and return their outputs (stdout and
    stderr, merged). Raises RuntimeError, after killing the other ranks,
    when a rank exits non-zero or the ranks are not all done within
    `timeout` seconds."""
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = "rank {} exited with {}".format(bad[0], procs[bad[0]].returncode)
                break
            if time.time() > deadline:
                failed = "ranks still running after {} s".format(timeout)
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = []
        for p in procs:
            p.wait()
            p.log.seek(0)
            outs.append(p.log.read())
            p.log.close()
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            failed = "rank {} exited with {}".format(bad[0], procs[bad[0]].returncode)
    if failed is not None:
        raise RuntimeError(failed + "".join(
            "\n--- rank {} ---\n{}".format(r, out[-6000:]) for r, out in enumerate(outs)))
    return outs


def _worker(rank, world, port, mode):
    """A stand-in rank: rank 1 fails or hangs, the others wait long."""
    if int(rank) == 1 and mode == "fail":
        raise SystemExit(3)
    if mode == "ok":
        print("rank {} of {} on port {}".format(rank, world, port))
        return
    time.sleep(600)


def test_run_ranks_returns_every_output():
    outs = run_ranks(__file__, ["ok"], 3, timeout=60)
    for r, out in enumerate(outs):
        assert "rank {} of 3".format(r) in out


@pytest.mark.parametrize("mode,timeout,within", [("fail", 60, 30), ("hang", 5, 30)])
def test_run_ranks_kills_the_rest(mode, timeout, within):
    """A failed rank, or the deadline, ends every rank at once and raises
    with their outputs."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 exited with 3" if mode == "fail"
                       else "still running"):
        run_ranks(__file__, [mode], 2, timeout=timeout)
    assert time.time() - t0 < within


if __name__ == "__main__":
    _worker(*sys.argv[1:])
