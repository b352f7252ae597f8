"""The expected-output harness of the tutorials.

Counterpart of ``petsc_tpu/utils/testing.py`` (the reference's test
mechanism: config/testparse.py, petsc_harness.sh): an example program runs
with an argument string, its standard output is captured, and the text is
compared with an expected output, numbers within a tolerance standing in
for the reference's sed ``filter:`` slack. ``run_example`` clears the
port's options database before the run.
"""

from __future__ import annotations

import contextlib
import io
import re

_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def run_example(main_fn, args: str | list, **kw):
    """Run an example's main() and return what it printed. Extra keyword
    arguments (device="cpu") go to main()."""
    from .. import config
    config.state().options.clear()
    if isinstance(args, str):
        args = args.split()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(list(args), **kw)
    return buf.getvalue()


def diff_output(actual: str, expected: str, rtol=1e-4, atol=1e-10):
    """Line-by-line comparison: text exact, numbers within rtol. Returns the
    list of mismatches (empty when the two agree)."""
    problems = []
    alines = [ln.rstrip() for ln in actual.strip().splitlines()]
    elines = [ln.rstrip() for ln in expected.strip().splitlines()]
    if len(alines) != len(elines):
        problems.append(f"line count {len(alines)} != expected {len(elines)}")
    for i, (a, e) in enumerate(zip(alines, elines)):
        if a == e:
            continue
        anums = _NUM.findall(a)
        enums = _NUM.findall(e)
        if _NUM.sub("#", a) != _NUM.sub("#", e) or len(anums) != len(enums):
            problems.append(f"line {i}: '{a}' != '{e}'")
            continue
        for x, y in zip(anums, enums):
            fx, fy = float(x), float(y)
            if abs(fx - fy) > atol + rtol * abs(fy):
                problems.append(f"line {i}: number {fx} != {fy} (rtol {rtol}): '{a}' vs '{e}'")
                break
    return problems


def assert_output(actual: str, expected: str, rtol=1e-4, atol=1e-10):
    problems = diff_output(actual, expected, rtol, atol)
    assert not problems, "output mismatch:\n" + "\n".join(problems) \
        + "\n--- actual ---\n" + actual
