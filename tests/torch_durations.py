"""Seconds per test file, their sum and the slowest tests, from a pytest
`--junitxml` report: how the port's CPU tests are timed.

    python -m pytest tests/test_torch_*.py -q -m 'not slow' \\
        -p no:cacheprovider -p xdist -n 6 --dist loadfile -p no:randomly \\
        --junitxml="$TMPDIR/port.xml"
    python tests/torch_durations.py "$TMPDIR/port.xml"

A test's seconds are its setup, call and teardown (the report's "time"),
so a module fixture counts in the first test that asks for it. The sum
over files is worker-seconds; the wall is pytest's own last line. Exits 1
when a test takes more than LIMIT_S seconds.
"""

import collections
import sys
import xml.etree.ElementTree as ET

SLOWEST = 15
LIMIT_S = 30.0


def main(report: str) -> int:
    per_file = collections.Counter()
    tests = []
    for case in ET.parse(report).getroot().iter("testcase"):
        seconds = float(case.get("time", 0.0))
        per_file[case.get("classname")] += seconds
        tests.append((seconds, f"{case.get('classname')}::{case.get('name')}"))
    for name, seconds in per_file.most_common():
        print(f"{seconds:9.1f}  {name}")
    print(f"{sum(per_file.values()):9.1f}  total worker-seconds, "
          f"{len(tests)} tests")
    tests.sort(reverse=True)
    print("slowest:")
    for seconds, name in tests[:SLOWEST]:
        print(f"{seconds:9.1f}  {name}")
    over = [name for seconds, name in tests if seconds > LIMIT_S]
    for name in over:
        print(f"over {LIMIT_S:g} s: {name}", file=sys.stderr)
    return 1 if over else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} REPORT.xml")
    sys.exit(main(sys.argv[1]))
