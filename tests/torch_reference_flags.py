"""Check that XLA:CPU's fusion emitters leave the port tests' vpt references
as they are.

tests/test_torch_wavefront.reference_env() runs every vpt reference
subprocess of the port's tests with --xla_cpu_use_fusion_emitters=false,
which makes their compiles cheaper. Loaded as a pytest plugin, this module
runs each such subprocess twice, first without the flag and then with it,
compares every array of the .npz files the two runs write, bit for bit,
and appends one JSON line per reference to a report: the test, the arrays
compared, those that differ (with their largest difference, absolute and
relative to max(1, |array|max)), and each run's seconds and CPU-seconds.
The tests get the flagged run's outputs, so they pass or fail as they do in
a normal run.

    python tests/torch_reference_flags.py [REPORT.jsonl] [PYTEST_ARGS...]

runs the port's test files (tests/test_torch_*.py, or PYTEST_ARGS) under
the plugin, writes the report (default build/reference_flags.jsonl,
emptied first) and prints a summary. Its exit code is pytest's.
"""
import glob
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FLAG = "--xla_cpu_use_fusion_emitters=false"
REPORT_ENV = "VPT_REFERENCE_FLAGS_REPORT"
REPO = Path(__file__).resolve().parents[1]

_run = subprocess.run


def _cpu_children() -> float:
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def _is_reference(args, env) -> bool:
    return (isinstance(args, list) and len(args) >= 4 and args[1] == "-c"
            and env is not None and FLAG in env.get("XLA_FLAGS", ""))


def _npz(paths) -> dict:
    out = {}
    for p in paths:
        with np.load(p) as z:
            out.update({f"{os.path.basename(p)}:{k}": z[k].copy()
                        for k in z.files})
    return out


def _diff(a: np.ndarray, b: np.ndarray):
    """None if a and b are the same bit for bit, else (abs, rel) of the
    largest difference (rel: over max(1, |a|max))."""
    if a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
            np.ascontiguousarray(a).view(np.uint8),
            np.ascontiguousarray(b).view(np.uint8)):
        return None
    if a.shape != b.shape or a.dtype.kind not in "fiu":
        return (float("inf"), float("inf"))
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    d = np.where(np.isnan(d), np.inf, d)
    scale = max(1.0, float(np.nanmax(np.abs(a), initial=0.0)))
    return (float(d.max(initial=0.0)), float(d.max(initial=0.0)) / scale)


def run(args, *a, **kw):
    """subprocess.run, which runs a vpt reference without the flag, then
    with it, and reports the difference."""
    env = kw.get("env")
    if not _is_reference(args, env):
        return _run(args, *a, **kw)
    where = os.path.dirname(args[3])
    before = set(glob.glob(os.path.join(where, "*.npz")))
    plain = dict(env, XLA_FLAGS=" ".join(
        f for f in env["XLA_FLAGS"].split() if f != FLAG))
    times = []
    outs = []
    for e in (plain, env):
        t0, c0 = time.perf_counter(), _cpu_children()
        res = _run(args, *a, **dict(kw, env=e))
        times.append([round(time.perf_counter() - t0, 1),
                      round(_cpu_children() - c0, 1)])
        new = sorted(set(glob.glob(os.path.join(where, "*.npz"))) - before)
        outs.append((res.returncode, _npz(new) if res.returncode == 0
                     else {}))
    (rc0, without), (rc1, flagged) = outs
    diffs = {}
    for k in sorted(set(without) | set(flagged)):
        if k not in without or k not in flagged:
            diffs[k] = "missing"
            continue
        d = _diff(without[k], flagged[k])
        if d is not None:
            diffs[k] = d
    line = {"test": os.environ.get("PYTEST_CURRENT_TEST", "?"),
            "rc": [rc0, rc1], "arrays": len(flagged), "differ": diffs,
            "seconds_cpu": {"without": times[0], "with": times[1]}}
    with open(os.environ.get(REPORT_ENV, REPO / "build"
                             / "reference_flags.jsonl"), "a") as f:
        f.write(json.dumps(line) + "\n")
    return res


def pytest_configure(config):
    subprocess.run = run


def summary(report: Path) -> str:
    lines = [json.loads(x) for x in report.read_text().splitlines() if x]
    arrays = sum(x["arrays"] for x in lines)
    out = [f"{len(lines)} references, {arrays} arrays; "
           f"{sum(len(x['differ']) for x in lines)} differ"]
    w = sum(x["seconds_cpu"]["without"][1] for x in lines)
    f = sum(x["seconds_cpu"]["with"][1] for x in lines)
    out.append(f"CPU-seconds without the flag {w:.1f}, with it {f:.1f}")
    for x in lines:
        out.append(f"  {x['test']}: rc {x['rc']}, {x['arrays']} arrays, "
                   f"s/CPU-s {x['seconds_cpu']}")
        for k, d in x["differ"].items():
            out.append(f"    differs: {k} {d}")
    return "\n".join(out)


def main(argv) -> int:
    given = bool(argv) and argv[0].endswith(".jsonl")
    report = Path(argv[0] if given else REPO / "build"
                  / "reference_flags.jsonl").resolve()
    rest = argv[1:] if given else argv
    report.parent.mkdir(parents=True, exist_ok=True)
    report.write_text("")
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, **{REPORT_ENV: str(report)}, PYTHONPATH=os.pathsep
               .join(filter(None, [str(tests), os.environ.get("PYTHONPATH")])))
    args = rest or sorted(str(p.relative_to(REPO)) for p in
                          tests.glob("test_torch_*.py"))
    rc = _run([sys.executable, "-m", "pytest", "-p", "torch_reference_flags",
               "-p", "no:cacheprovider", *args], cwd=REPO, env=env).returncode
    print(summary(report))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
