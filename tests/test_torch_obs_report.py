"""The port's ``tools/obs_report.py`` against the JAX package's
``scripts/obs_report.py`` on the same files.

The twin's ``--selftest`` writes one set of artifacts of every kind the
report reads (metrics with ``skip``/``rollback``/``preempt`` events and a
torn last line, heartbeats, a telemetry CSV, comm and memory ledgers, an
autoplan payload, a temporary LKG read at a fixed ``--now``, synclint
captures, flight dumps, ``reqtrace`` and ``fleettrace`` records) and calls
``report``, ``report_json``, ``run_diff`` and ``main`` on them, ``--diff``
and ``--strict`` included.  Here every one of those calls runs the JAX
function too, on the same arguments: the text, the JSON and the exit codes
must be equal.  One difference is by design: the twin ages only the LKG and
events files it is given, where the JAX script falls back to its checkout's
own files; the JAX calls get a missing file in their place.
"""

import contextlib
import copy
import importlib.util
import io
import os
import subprocess
import sys

from pytorch_distributed_tpu_torch.tools import obs_report as twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_obs_report", os.path.join(REPO, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = fn(*args, **kw)
    return got, buf.getvalue()


def test_every_selftest_call_matches_the_jax_script(monkeypatch, tmp_path):
    jax_report = _jax_script()
    missing = str(tmp_path / "no_such_file")
    calls = []

    def with_named_files(ns):
        ns = copy.copy(ns)
        for name in ("bench_lkg", "bench_events"):
            if getattr(ns, name, None) is None:
                setattr(ns, name, missing)
        return ns

    def paired(name, jax_args):
        mine = getattr(twin, name)

        def both(*args, **kw):
            got, out = _captured(mine, *args, **kw)
            want, jout = _captured(getattr(jax_report, name), *jax_args(args), **kw)
            calls.append((name, args, got, want, out, jout))
            sys.stdout.write(out)
            return got
        monkeypatch.setattr(twin, name, both)

    def main_args(args):
        argv = list(args[0])
        for flag in ("--bench-lkg", "--bench-events"):
            if flag not in argv and "--diff" not in argv and "--selftest" not in argv:
                argv += [flag, missing]
        return (argv,)

    paired("report", lambda a: (with_named_files(a[0]),) + a[1:])
    paired("report_json", lambda a: (with_named_files(a[0]),) + a[1:])
    paired("run_diff", lambda a: a)
    paired("main", main_args)
    assert _captured(twin._selftest)[0] == 0
    kinds = {c[0] for c in calls}
    assert kinds == {"report", "report_json", "run_diff", "main"} and len(calls) >= 30
    for name, args, got, want, out, jout in calls:
        assert got == want, (name, args)
        assert out == jout, (name, args)


def test_selftest_and_diff_exit_codes_from_the_command_line(tmp_path):
    """The module runs as a command without JAX on its path: ``--selftest``
    exits 0 on any date, and ``--diff`` of a run against itself passes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "pytorch_distributed_tpu_torch.tools.obs_report"]
    probe = ("import runpy, sys; sys.argv = ['obs_report', '--selftest']; "
             "sys.modules['jax'] = None; sys.modules['pytorch_distributed_tpu'] = None; "
             "runpy.run_module('pytorch_distributed_tpu_torch.tools.obs_report', "
             "run_name='__main__')")
    got = subprocess.run([sys.executable, "-c", probe], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0 and "obs_report selftest: OK" in got.stdout, got.stderr[-2000:]
    m = tmp_path / "m.jsonl"
    m.write_text("".join(f'{{"step": {i}, "t": {i}.0, "step_time": 0.1, "loss": 1.0}}\n'
                         for i in range(8)))
    got = subprocess.run(run + ["--diff", str(m), str(m)], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0 and "PASS" in got.stdout, got.stdout + got.stderr[-2000:]
